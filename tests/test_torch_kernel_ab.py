"""The host-side logic of `vosesam_tpu_torch.ops.kernels.ab`, the tool that
times this checkout's kernels against another checkout's on the card: how
it feeds a B3 wrapper that takes only contiguous (B * heads, N, D) tensors,
how it summarises the two runs of each side, that it refuses to run
without a card, and how its device-time reading (which `chip_smoke.py`
and the phases tool share) survives torch.profiler's lost kernel records.
The timings themselves run only on the card."""

import types

import torch

from vosesam_tpu_torch.ops.kernels import ab


def _views(b=1, heads=2, n=6, d=4, gh=2, gw=3):
    qkv = torch.randn(b, n, 3, heads, d)
    q, k, v = (x.transpose(1, 2) for x in qkv.unbind(2))
    return q, k, v, torch.randn(b, heads, n, gh), torch.randn(b, heads, n, gw)


def test_b3_call_passes_strided_views_to_a_wrapper_that_takes_them():
    seen = []
    fa = types.SimpleNamespace(flash_attention_relpos=lambda *a: seen.append(a))
    q, k, v, bh, bw = _views()
    fn, layout = ab._b3_call(fa, q, k, v, bh, bw, (2, 3))
    fn()
    assert layout == "strided (B, heads, N, D)"
    assert len(seen) == 2 and seen[-1][0] is q and not seen[-1][0].is_contiguous()


def test_b3_call_falls_back_to_contiguous_flat_tensors():
    seen = []

    def wrapper(q, k, v, bh, bw, grid):
        if q.ndim != 3:
            raise ValueError("q must be (BH, N, D)")
        seen.append((q, k, v, bh, bw, grid))

    q, k, v, bh, bw = _views(b=2)
    fn, layout = ab._b3_call(types.SimpleNamespace(flash_attention_relpos=wrapper),
                             q, k, v, bh, bw, (2, 3))
    fn()
    assert layout == "contiguous (B * heads, N, D)"
    fq, fk, fv, fbh, fbw, grid = seen[-1]
    assert grid == (2, 3) and all(t.is_contiguous() for t in (fq, fk, fv, fbh, fbw))
    assert fq.shape == (4, 6, 4) and fbh.shape == (4, 6, 2) and fbw.shape == (4, 6, 3)
    torch.testing.assert_close(fq, q.reshape(4, 6, 4), rtol=0, atol=0)
    torch.testing.assert_close(fv, v.reshape(4, 6, 4), rtol=0, atol=0)


def test_summary_gives_both_runs_and_the_ratio_of_the_means():
    def run(scale):
        return {"B3 rect": {k: scale * t for k, t in
                            (("device_ms", 1.0), ("event_ms", 2.0), ("batched_ms", 1.5),
                             ("host_ms", 0.1))}}

    lines = ab.summary({"against": [run(4.0), run(6.0)], "this": [run(1.0), run(1.0)]})
    assert len(lines) == 4
    device = next(line for line in lines if "device_ms" in line)
    assert "against 4.0000 / 6.0000" in device and "this 1.0000 / 1.0000" in device
    assert device.endswith("ratio 5.00")


def test_main_refuses_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert ab.main(["--against", "."]) == 1
    assert "no CUDA device" in capsys.readouterr().out


class _FakeProfile:
    """torch.profiler.profile's stand-in: its key_averages() are the given
    kernel records, (count, total microseconds) each."""

    def __init__(self, records, **_):
        self.records = records

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def key_averages(self):
        cuda = types.SimpleNamespace(name="CUDA")
        return [types.SimpleNamespace(device_type=cuda, count=c, self_device_time_total=t)
                for c, t in self.records]


def test_device_ms_survives_lost_kernel_records(monkeypatch):
    import torch.profiler

    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    cases = {
        # (kernel records kept, ...) over 20 calls -> ms per call
        ((20, 20 * 77.0),): 0.077,               # every record kept
        ((10, 10 * 77.0),): 0.077,               # the first half lost
        ((18, 18 * 75.0), (37, 37 * 2.0)): 0.079,  # one kernel once a call, one twice
        ((2, 2 * 5.0), (20, 20 * 100.0)): 0.1005,  # a kernel that runs once per 10 calls
    }
    for records, want in cases.items():
        monkeypatch.setattr(torch.profiler, "profile",
                            lambda records=records, **kw: _FakeProfile(records, **kw))
        got = ab.device_ms(lambda: None, calls=20, warmup=0)
        assert abs(got - want) < 1e-9, (records, got, want)
