"""Where the float32 kernel path of zamba2-2.7b loses digits: each path
against a float64 plain run, on one NVIDIA GPU.

  PYTHONPATH=src python tools/f32_witness.py

On ``init_params``' weights (``torch.Generator(0)``) and the prefill batch
of ``chip_smoke.py`` (B=4 x S=2048), the float32 prefill runs with both
kernels, with neither, and with flash attention (B4) or the SSD scan (B6)
alone; each run's last-token logits are compared with the float64 plain
run's.  The scan's inputs at mamba layers 0, 27 and 53 of the first run
are then replayed through the scan kernel, its plain version in float32
and the plain version in float64 (y and the final state), and through the
backward kernel, its plain reverse scan and autograd of the float64 plain
scan (against a seeded gy).  Prints max and mean |err| of each; gates
nothing (``chip_smoke.py`` holds the gates)."""
import numpy as np
import torch

from repro_torch import models
from repro_torch.configs import get_config
from repro_torch.kernels import _build
from repro_torch.kernels.attention import ops as attn_ops
from repro_torch.kernels.attention import ref as attn_ref
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.kernels.ssd import ref as ssd_ref
from repro_torch.launch.steps import make_prefill_step

LAYERS = (0, 27, 53)   # the mamba layers whose scan inputs are replayed


def plain_attention(q, k, v, *, causal=True):
    h = q.shape[2]
    return attn_ref.mha(q, attn_ref.broadcast_kv(k, h),
                        attn_ref.broadcast_kv(v, h), causal=causal)


def report(tag, got, want):
    d = (got.double() - want.double()).abs()
    print(f"{tag}: max |err| {float(d.max()):.6g}, mean {float(d.mean()):.6g}"
          f" (max |want| {float(want.abs().max()):.6g})")


def main():
    _build.build(["flash_attention", "ssd_scan", "ssd_scan_bwd"])
    dev = torch.device("cuda")
    cfg = get_config("zamba2-2.7b")
    params = models.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    batch = {"tokens": torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, (4, 2048)), device=dev)}
    kernel_attn, kernel_ssd = attn_ops.attention, ssd_ops.ssd
    kept, calls = {}, [0]

    def recording_ssd(x, dt, a, B, C, d_skip=None, **kw):
        if calls[0] in LAYERS:
            kept[calls[0]] = (x, dt, a, B, C, d_skip)
        calls[0] += 1
        return kernel_ssd(x, dt, a, B, C, d_skip=d_skip, **kw)

    w64 = models.cast_params(params, torch.float64)
    ref = make_prefill_step(cfg, compute_dtype=torch.float64,
                            kernels=False)(w64, batch)[:, -1]
    del w64
    runs = (("both kernels", kernel_attn, recording_ssd, True),
            ("plain", kernel_attn, kernel_ssd, False),
            ("B4 alone", kernel_attn, ssd_ref.ssd_chunked, True),
            ("B6 alone", plain_attention, kernel_ssd, True))
    try:
        for name, attn, ssd, kernels in runs:
            attn_ops.attention, ssd_ops.ssd = attn, ssd
            lg = make_prefill_step(cfg, compute_dtype=torch.float32,
                                   kernels=kernels)(params, batch)[:, -1]
            report(f"prefill float32, {name}, vs float64 plain", lg, ref)
    finally:
        attn_ops.attention, ssd_ops.ssd = kernel_attn, kernel_ssd

    gen = torch.Generator(device=dev).manual_seed(1)
    for layer, args in kept.items():
        x, dt, a, B, C, d = (t.detach() for t in args)
        cum = torch.cumsum((dt * a).reshape(x.shape[0], -1, 64, x.shape[2]), 2)
        print(f"layer {layer}: dt in [{float(dt.min()):.3g}, "
              f"{float(dt.max()):.4g}], a in [{float(a.min()):.4g}, "
              f"{float(a.max()):.4g}], max |cum| {float(cum.abs().max()):.6g}")
        wide = [t.double() for t in (x, dt, a, B, C, d)]
        got = ssd_ops.ssd(x, dt, a, B, C, d_skip=d)
        plain = ssd_ref.ssd_chunked(x, dt, a, B, C, d_skip=d)
        want = ssd_ref.ssd_chunked(*wide[:5], d_skip=wide[5])
        for i, name in enumerate(("y", "state")):
            report(f"  scan {name}, kernel vs float64 plain", got[i], want[i])
            report(f"  scan {name}, plain vs float64 plain", plain[i], want[i])
        gy = torch.randn(x.shape, generator=gen, device=dev)
        wide = [t.requires_grad_(True) for t in wide]
        y, _ = ssd_ref.ssd_chunked(*wide[:5], d_skip=wide[5])
        want = torch.autograd.grad(y, wide, gy.double())
        got = ssd_ops.ssd_bwd(x, dt, a, B, C, d, gy=gy)
        plain = ssd_ref.ssd_chunked_bwd(x, dt, a, B, C, d_skip=d, gy=gy)
        for i, name in enumerate(("dx", "ddt", "da", "dB", "dC", "dD")):
            report(f"  backward {name}, kernel vs float64", got[i], want[i])
            report(f"  backward {name}, plain vs float64", plain[i], want[i])


if __name__ == "__main__":
    main()
