"""An XMem step's frame size, object slots and whether it wrote memory
(the state's host counters after the step)."""


def probe(args, kwargs, out, store):
    state, frame = out[0], args[2]
    return {"hw": (int(frame.shape[0]), int(frame.shape[1])),
            "objects": int(state.memory.obj_valid.shape[0]),
            "memory_frame": state.last_mem_ti == state.curr_ti}
