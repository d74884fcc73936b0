"""The benchmark's plain reference: a frozen copy of the port's plain model
code (XMem-s012, SAM / SAM-HQ, the memory manager, the tracker step, the
refinement and its prompt geometry), with its imports rewritten to this
package, every kernel call replaced by the plain computation it stands for
and tensor parallelism taken out. It imports nothing of the port, so a later
change to the port does not move it. Run it in float32 with TF32 off
(`benchmark/harness/reference.py`)."""
