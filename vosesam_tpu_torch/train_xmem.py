"""Train XMem on a DAVIS-style tree (port of `scripts/train_xmem.py`): the
end-to-end loop the reference's vestigial trainer was meant to run.

    python -m vosesam_tpu_torch.train_xmem --data /path/to/DAVIS --steps 1000 \\
        --batch 4 --grad-accum 2 --save xmem_train.pth [--imset 2017/train.txt] \\
        [--device cpu]

Runs on the card unless `--device cpu`. `--dp` (data parallel over
devices) is not ported yet and raises. Max-skip curriculum: max_jump steps
5 -> 10 -> 15 -> 5 at the standard [10%, 30%, 80%] fractions of the steps.
`--save` writes a `torch.save` file that `TrackingAnything(xmem_checkpoint=...)`
loads; `--resume` restores the network, the optimizer and the iteration.
"""

from __future__ import annotations

import argparse
import math
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Train XMem on a DAVIS-style tree")
    ap.add_argument("--data", required=True)
    ap.add_argument("--imset", default="2017/train.txt")
    ap.add_argument("--steps", type=int, default=1000)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq-length", type=int, default=8)
    ap.add_argument("--crop", type=int, default=384)
    ap.add_argument("--lr", type=float, default=1e-5)
    ap.add_argument("--max-objects", type=int, default=3)
    ap.add_argument("--key-dim", type=int, default=64)
    ap.add_argument("--value-dim", type=int, default=512)
    ap.add_argument("--hidden-dim", type=int, default=64)
    ap.add_argument("--save", default=None, help="checkpoint file to write")
    ap.add_argument("--resume", default=None)
    ap.add_argument("--log-every", type=int, default=20)
    ap.add_argument("--grad-accum", type=int, default=1,
                    help="sequential microbatches per optimizer step")
    ap.add_argument("--dp", action="store_true",
                    help="data parallel over devices (not ported yet)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.dp:
        raise NotImplementedError("--dp: data-parallel training is not ported yet")

    import torch

    from vosesam_tpu_torch.config import FrameworkConfig, XMemConfig
    from vosesam_tpu_torch.device import resolve_device
    from vosesam_tpu_torch.eval.datasets import DavisDataset
    from vosesam_tpu_torch.models.xmem.network import xmem_init
    from vosesam_tpu_torch.training import trainer as T
    from vosesam_tpu_torch.training.data import ClipSampler, ClipSamplerConfig

    dev = resolve_device(args.device)
    cfg = FrameworkConfig(
        xmem=XMemConfig(max_objects=args.max_objects, key_dim=args.key_dim,
                        value_dim=args.value_dim, hidden_dim=args.hidden_dim),
        dtype="float32")
    tcfg = T.TrainConfig(lr=args.lr, seq_length=args.seq_length, grad_accum=args.grad_accum)
    ds = DavisDataset(args.data, imset=args.imset)
    sampler = ClipSampler(ds, ClipSamplerConfig(seq_length=args.seq_length, crop=args.crop),
                          args.max_objects, seed=args.seed)
    state = T.init_train_state(xmem_init(cfg.xmem, seed=args.seed, device=dev), tcfg)
    if args.resume:
        state = T.load_checkpoint(args.resume, state)

    # max-skip curriculum at the standard step fractions
    schedule = [(0.1, 10), (0.3, 15), (0.8, 5)]
    start_it = state.it
    # on resume, apply the latest boundary already passed
    for frac, jump in schedule:
        if start_it >= int(args.steps * frac):
            sampler.set_max_jump(jump)
            print(f"[resume {start_it}] max_jump -> {jump}", flush=True)
    t0 = time.time()
    for it in range(start_it, args.steps):
        for frac, jump in schedule:
            if it == int(args.steps * frac) and it != start_it:
                sampler.set_max_jump(jump)
                print(f"[{it}] max_jump -> {jump}", flush=True)
        frames, gt, valid = sampler.sample_batch(args.batch)
        batch = (torch.from_numpy(frames).float().to(dev), torch.from_numpy(gt).to(dev),
                 torch.from_numpy(valid).to(dev))
        state, aux = T.train_step(state, *batch, cfg, tcfg)
        if it % args.log_every == 0 or it == args.steps - 1:
            loss = float(aux["loss"])
            if not math.isfinite(loss):
                raise RuntimeError(f"non-finite loss at step {it}")
            rate = (it + 1 - start_it) / max(time.time() - t0, 1e-9)
            print(f"[{it}] loss {loss:.4f}  ({rate:.2f} it/s)", flush=True)

    if args.save:
        T.save_checkpoint(state, args.save)
        print(f"saved {args.save}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
