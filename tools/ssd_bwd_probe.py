"""Probe the bfloat16 SSD backward kernels (``csrc/ssd_scan_bwd.cu``).

  PYTHONPATH=src python tools/ssd_bwd_probe.py           # one NVIDIA GPU
  PYTHONPATH=src python tools/ssd_bwd_probe.py --cpu 30  # the model only

On the card: builds the library, prints ptxas's registers and spills and
the HGMMA count of each kernel, then for a set of seeded cases holds the
kernels' outputs and their bf16 state scratch (the walk's h_c and dh_c)
against ``ref.ssd_bwd_model``, and prints each gradient's mean and max
error from the float32 autograd gradients as a ratio of the bfloat16 plain
path's (the rule ``chip_smoke.py`` gates: 1.25 and 2); then times a call
at the training shape (B=4 S=2048 H=80 P=64 N=64) with CUDA events and
each kernel's device time under the profiler.

With ``--cpu K``: the same ratios for ``ref.ssd_bwd_model`` against torch's
bfloat16 autograd on the CPU, over K seeds of a few small cases, and how
many seeds miss the rule.  Gates nothing."""
import argparse
import collections
import subprocess
import sys
from pathlib import Path

import torch

from repro_torch.kernels.ssd import ops, ref

NAMES = ("dx", "ddt", "da", "dB", "dC", "dD", "dh0")
# (b, s, h, p, n, warm start, d_skip, gy, gstate)
CASES = [(2, 200, 3, 64, 64, True, True, True, True),
         (2, 1, 5, 64, 64, True, True, True, True),
         (1, 1000, 4, 64, 64, True, True, True, True),
         (2, 130, 3, 16, 128, True, False, True, True),
         (1, 64, 2, 32, 96, False, True, False, True),
         (1, 65, 2, 64, 64, False, True, True, False),
         (2, 2048, 10, 64, 64, False, True, True, False),
         (1, 300, 9, 64, 64, True, True, True, True)]


def inputs(case, gen, dev):
    b, s, h, p, n, warm, skip, use_gy, use_gs = case

    def rn(shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    bf = torch.bfloat16
    x = rn((b, s, h, p), bf)
    dt = torch.nn.functional.softplus(rn((b, s, h)) - 1.0)
    a = -torch.exp(torch.rand(h, generator=gen, device=dev) * 1.5)
    B = (rn((b, s, n)) * n ** -0.5).to(bf)
    C = (rn((b, s, n)) * n ** -0.5).to(bf)
    d = torch.linspace(0.5, 1.5, h, device=dev)
    h0 = rn((b, h, p, n)) if warm else None
    gy = rn((b, s, h, p), bf) if use_gy else None
    gs = rn((b, h, p, n)) if use_gs else None
    return [x, dt, a, B, C, d if skip else None, h0], gy, gs


def autograd(args, gy, gs):
    leaves = [None if t is None else t.detach().requires_grad_() for t in args]
    y, st = ref.ssd_chunked(*leaves[:5], d_skip=leaves[5],
                            initial_state=leaves[6])
    outs = [(o, g.to(o.dtype)) for o, g in ((y, gy), (st, gs)) if g is not None]
    idx = [i for i, t in enumerate(leaves) if t is not None]
    got = torch.autograd.grad([o for o, _ in outs], [leaves[i] for i in idx],
                              [g for _, g in outs], allow_unused=True)
    out = [None] * 7
    for i, g in zip(idx, got):
        out[i] = torch.zeros_like(leaves[i]) if g is None else g
    return out


def ratios(got, args, gy, gs):
    """{name: (mean ratio, max ratio)} of got's error from the float32
    autograd gradients to the bfloat16 plain path's."""
    plain = autograd(args, gy, gs)
    f32 = [None if t is None else t.float() for t in args]
    if args[6] is not None:       # the scan rounds its warm start to bf16
        f32[6] = args[6].to(torch.bfloat16).float()
    want = autograd(f32, None if gy is None else gy.float(), gs)
    out = {}
    for name, g, w, r in zip(NAMES, got, plain, want):
        if g is None:
            continue
        ours = (g.double() - r.double()).abs()
        theirs = (w.double() - r.double()).abs()
        out[name] = (float(ours.mean()) / max(float(theirs.mean()), 1e-30),
                     float(ours.max()) / max(float(theirs.max()), 1e-30))
    return out


def misses(r):
    return [k for k, (m, x) in r.items() if m > 1.25 or x > 2.0]


def model_states(args, gy, gs, nm):
    """The walk's bf16 scratch as ``ref.ssd_bwd_model`` forms it: h_c and
    dh_c [B, H, nc, NM, 64], rows n of 64 p."""
    x, dt, a, B, C, _, h0 = args
    b, s, h, p = x.shape
    n, q = B.shape[-1], ops.CHUNK
    if gy is None:
        gy = torch.zeros_like(x)
    pad = (-s) % q
    if pad:
        x, dt, B, C, gy = (ref._pad_seq(t, pad) for t in (x, dt, B, C, gy))
    nc = (s + pad) // q
    xc, gyc = (t.reshape(b, nc, q, h, p).float() for t in (x, gy))
    dtc = dt.reshape(b, nc, q, h).float()
    Bc, Cc = (t.reshape(b, nc, q, n).float() for t in (B, C))
    cum = torch.cumsum(dtc * a.float(), 2)
    seg = cum[:, :, -1]
    hs, dhs, _ = ref._model_walks(xc, dtc, Bc, Cc, gyc, torch.exp(cum),
                                  torch.exp(seg[:, :, None] - cum),
                                  torch.exp(seg), h0, gs, x.dtype)

    def image(states):   # [b, nc, h, p, n] -> [b, h, nc, NM, 64]
        out = torch.zeros((b, h, nc, nm, 64), device=x.device)
        out[:, :, :, :n, :p] = states.permute(0, 2, 1, 4, 3)
        return out

    return image(hs), image(dhs)


def on_card():
    from repro_torch.kernels import _build
    lib = _build.build(["ssd_scan_bwd"])["ssd_scan_bwd"]
    for line in lib.with_suffix(".log").read_text().splitlines():
        if "entry function" in line or "registers" in line or "spill" in line:
            print("  " + line.strip()[:160])
    sass = subprocess.run([str(Path(_build._nvcc()).parent / "cuobjdump"),
                           "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    fn, hgmma = None, collections.Counter()
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
        elif "HGMMA" in line:
            hgmma[fn] += 1
    print("HGMMA:", dict(hgmma))

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    captured, real_empty = [], torch.empty

    def capturing_empty(*a, **k):   # the wrapper's state scratch
        t = real_empty(*a, **k)
        if t.dim() == 6:
            captured.append(t)
        return t

    for case in CASES:
        args, gy, gs = inputs(case, gen, dev)
        captured.clear()
        torch.empty = capturing_empty
        try:
            got = ops.ssd_bwd(*args, gy=gy, gstate=gs)
        finally:
            torch.empty = real_empty
        again = ops.ssd_bwd(*args, gy=gy, gstate=gs)
        same = all(g is None or torch.equal(g, g2) for g, g2 in zip(got, again))
        nm = 64 if case[4] <= 64 else 128
        line = f"{case}: two calls bitwise {same}"
        for label, k, m in zip(("h_c", "dh_c"), captured[0],
                               model_states(args, gy, gs, nm)):
            line += (f"; {label} vs model {float((k.float() - m).abs().max()):.3g}"
                     f" (max {float(m.abs().max()):.3g})")
        want = ref.ssd_bwd_model(*args[:5], d_skip=args[5],
                                 initial_state=args[6], gy=gy, gstate=gs)
        line += "\n  vs model, max |err| / max |g|: " + ", ".join(
            f"{k} {float((g.double() - w.double()).abs().max()) / max(float(w.abs().max()), 1e-30):.3g}"
            for k, g, w in zip(NAMES, got, want) if g is not None)
        r = ratios(got, args, gy, gs)
        line += "\n  error / the bf16 plain path's (mean/max): " + ", ".join(
            f"{k} {m:.2f}/{x:.2f}" for k, (m, x) in r.items())
        line += f"; outside the rule: {misses(r) or 'none'}"
        print(line, flush=True)

    b, s, h, p, n = 4, 2048, 80, 64, 64
    args, gy, _ = inputs((b, s, h, p, n, False, True, True, False), gen, dev)
    for _ in range(3):
        ops.ssd_bwd(*args, gy=gy)
    times = []
    for _ in range(5):
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        for _ in range(20):
            ops.ssd_bwd(*args, gy=gy)
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1) / 20)
    print(f"training shape, bf16: {sorted(times)[2]:.4f} ms a call (median of "
          f"5 x 20; {[round(t, 4) for t in times]})")
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            ops.ssd_bwd(*args, gy=gy)
        torch.cuda.synchronize()
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0:
            print(f"  {e.key[:60]}: {e.self_device_time_total / e.count:.1f} "
                  "us a launch")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())


def on_cpu(seeds):
    torch.set_num_threads(4)
    for case in ((1, 64, 2, 32, 96, False, True, False, True),
                 (2, 130, 3, 16, 128, True, False, True, True),
                 (2, 300, 8, 64, 64, True, True, True, True)):
        missed = collections.Counter()
        worst = collections.defaultdict(lambda: (0.0, 0.0))
        for seed in range(seeds):
            gen = torch.Generator().manual_seed(100 + seed)
            args, gy, gs = inputs(case, gen, torch.device("cpu"))
            got = ref.ssd_bwd_model(*args[:5], d_skip=args[5],
                                    initial_state=args[6], gy=gy, gstate=gs)
            r = ratios(got, args, gy, gs)
            missed.update(misses(r))
            for k, (m, x) in r.items():
                worst[k] = (max(worst[k][0], m), max(worst[k][1], x))
        print(f"{case}: seeds outside the rule, of {seeds}: {dict(missed)}; "
              "worst mean/max ratio: "
              + ", ".join(f"{k} {m:.2f}/{x:.2f}" for k, (m, x) in worst.items()))


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--cpu", type=int, default=0, metavar="SEEDS")
    opts = parser.parse_args()
    if opts.cpu:
        on_cpu(opts.cpu)
    elif not torch.cuda.is_available():
        sys.exit("no CUDA device (use --cpu SEEDS for the model alone)")
    else:
        on_card()
