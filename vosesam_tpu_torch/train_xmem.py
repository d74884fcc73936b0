"""Train XMem on a DAVIS-style tree (port of `scripts/train_xmem.py`): the
end-to-end loop the reference's vestigial trainer was meant to run.

    python -m vosesam_tpu_torch.train_xmem --data /path/to/DAVIS --steps 1000 \\
        --batch 4 --grad-accum 2 --save xmem_train.pth [--imset 2017/train.txt] \\
        [--device cpu]

Runs on the card unless `--device cpu`. `--dp`: data parallel over the
ranks of the process group (each rank samples the same global batch from
the same seed and trains on its B / world clips; the gradients are
all-reduced: `training/trainer.py`); one process is a group of one (NCCL on
the card, gloo with `--device cpu`), n cards take `torchrun
--nproc_per_node n -m vosesam_tpu_torch.train_xmem ... --dp`; rank 0 logs
and saves. Max-skip curriculum: max_jump steps
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
                    help="data parallel over the ranks of the process group")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from vosesam_tpu_torch.parallel import mesh as meshlib

    with meshlib.owned_group():
        return _train(ap, args)


def _train(ap: argparse.ArgumentParser, args: argparse.Namespace) -> int:
    import torch

    from vosesam_tpu_torch.config import FrameworkConfig, ParallelConfig, XMemConfig
    from vosesam_tpu_torch.device import resolve_device
    from vosesam_tpu_torch.eval.datasets import DavisDataset
    from vosesam_tpu_torch.models.xmem.network import xmem_init
    from vosesam_tpu_torch.parallel import mesh as meshlib
    from vosesam_tpu_torch.training import trainer as T
    from vosesam_tpu_torch.training.data import ClipSampler, ClipSamplerConfig

    dev = resolve_device(args.device)
    mesh = None
    if args.dp:
        meshlib.ensure_distributed(dev)
        mesh = meshlib.make_mesh(ParallelConfig())
        if args.batch % mesh.data_size:
            ap.error(f"--batch must divide the {mesh.data_size}-way data axis")

    def log(msg: str) -> None:
        if meshlib.is_writer():
            print(msg, flush=True)

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
            log(f"[resume {start_it}] max_jump -> {jump}")
    t0 = time.time()
    for it in range(start_it, args.steps):
        for frac, jump in schedule:
            if it == int(args.steps * frac) and it != start_it:
                sampler.set_max_jump(jump)
                log(f"[{it}] max_jump -> {jump}")
        frames, gt, valid = sampler.sample_batch(args.batch)
        batch = (torch.from_numpy(frames).float().to(dev), torch.from_numpy(gt).to(dev),
                 torch.from_numpy(valid).to(dev))
        state, aux = T.train_step(state, *batch, cfg, tcfg, mesh=mesh)
        if it % args.log_every == 0 or it == args.steps - 1:
            loss = float(aux["loss"])
            if not math.isfinite(loss):
                raise RuntimeError(f"non-finite loss at step {it}")
            rate = (it + 1 - start_it) / max(time.time() - t0, 1e-9)
            log(f"[{it}] loss {loss:.4f}  ({rate:.2f} it/s)")

    if args.save and meshlib.is_writer():
        T.save_checkpoint(state, args.save)
        log(f"saved {args.save}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
