#!/usr/bin/env python3
"""K1 (RMSNorm, its forward and its gradient) and ``int8_matmul``'s M <= 64
seams on one GPU, at the shapes the paths launch them, for one tree of the
port:

    python3 tools/k1_int8_bench.py [--root DIR] [--out FILE]

``--root`` takes ``k8s_dra_driver_tpu_torch`` from another checkout (an
older tree unpacked by ``git archive``; its kernels build into that
tree's ``build/kernels``), so two trees can be timed in turns inside one
call on one card (parent, change, change, parent). The timing is this
tree's ``chip_smoke.time_ms`` (median of 20 calls by CUDA events, L2
evicted before each call) for every tree.

1. ``rmsnorm``: the forward through ``norms.rmsnorm`` at chip_smoke's
   RMSNORM_SHAPES (bf16, eps 1e-5), beside ``F.rms_norm``; up to 512
   rows also ``graph_ms``, a launch's device time among 50 in one CUDA
   graph (the captured decode step's setting, inputs hot in L2), and
   ``profiled_ms``, the kernel's own duration as ``torch.profiler``
   reads it (the decode step profile's groups).
2. ``rmsnorm_grad``: the gradient at chip_smoke's RMSNORM_BACKWARD_SHAPES
   as training takes it, ``torch.autograd.grad`` through
   ``norms.rmsnorm``'s output (the tree's ``RMSNormFunction.backward``:
   the gradient kernel, or an older tree's autograd recompute), beside
   the same through ``F.rms_norm``.
3. ``int8_matmul``: the seams (chip_smoke's INT8_SEAMS) at M 1, 5, 8, 16
   and 64 in both modes, beside a bf16 ``torch.matmul`` on the weight
   converted beforehand.
4. ``explore`` (``--explore``, this tree only): the seams at M 8 through
   the library's C entry with each K split the swapped form takes, and
   K1's forward at each shape as one CTA a row and as clusters of 2, 4
   and 8 CTAs a row.

Each time sits beside its bound (chip_smoke.bound_fields: bytes at 3.35
TB/s, operations at the card's peak). Prints the card's name and power
limit, then one JSON line (also written to ``--out``)."""

import argparse
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

SEAM_MS = (1, 5, 8, 16, 64)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(ROOT))
    ap.add_argument("--out", default=None)
    ap.add_argument("--explore", action="store_true",
                    help="also time every K split of the M <= 64 seams and "
                         "every form of K1 through the C entry points")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k1_int8_bench: no CUDA device", file=sys.stderr)
        return 2
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    os.environ.setdefault("TRITON_CACHE_DIR", str(root / "build" / "triton"))
    from k8s_dra_driver_tpu_torch.ops import norms
    from k8s_dra_driver_tpu_torch.ops import quant_matmul as qm

    if not Path(norms.__file__).resolve().is_relative_to(root):
        raise RuntimeError(f"imported {norms.__file__}, not from {root}")
    F = torch.nn.functional
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=dev)
    gen.manual_seed(cs.SEED + 90)
    eps = 1e-5
    out = {"root": str(root), "rmsnorm": {}, "rmsnorm_grad": {},
           "int8_matmul": {}}

    def bf16(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(
            torch.bfloat16)

    for name, rows, d in cs.RMSNORM_SHAPES:
        x, w = bf16(rows, d), (1 + 0.1 * bf16(d)).to(torch.bfloat16)
        out["rmsnorm"][f"x[{rows},{d}]"] = dict(
            ms=cs.time_ms(lambda: norms.rmsnorm(x, w, eps)),
            library_ms=cs.time_ms(lambda: F.rms_norm(x, (d,), w, eps)),
            **cs.bound_fields(name, 2 * x.numel() * 2 + d * 2,
                              4 * x.numel(), cs.F32_FLOPS))
        if rows <= 512:
            out["rmsnorm"][f"x[{rows},{d}]"].update(
                graph_ms=cs.graph_ms(torch, lambda: norms.rmsnorm(x, w, eps)),
                profiled_ms=profiled_ms(torch,
                                        lambda: norms.rmsnorm(x, w, eps)))
    for name, rows, d in cs.RMSNORM_BACKWARD_SHAPES:
        x, w, g = bf16(rows, d), (1 + 0.1 * bf16(d)).to(torch.bfloat16), \
            bf16(rows, d)
        times = {}
        for label, fn in (("ms", norms.rmsnorm),
                          ("library_ms",
                           lambda a, b, e: F.rms_norm(a, (d,), b, e))):
            xl, wl = x.clone().requires_grad_(), w.clone().requires_grad_()
            y = fn(xl, wl, eps)
            times[label] = cs.time_ms(lambda: torch.autograd.grad(
                y, (xl, wl), g, retain_graph=True))
            del xl, wl, y
        out["rmsnorm_grad"][f"x[{rows},{d}]"] = dict(
            **times, **cs.bound_fields(
                name, 3 * x.numel() * 2 + 2 * d * 2, 8 * x.numel(),
                cs.F32_FLOPS))
        del x, w, g
        torch.cuda.empty_cache()

    for name, k, n in cs.INT8_SEAMS:
        q = torch.randint(-127, 128, (k, n), generator=gen, device=dev,
                          dtype=torch.int8)
        scale = (0.5 + torch.rand((1, n), generator=gen, device=dev)) / (
            127 * k ** 0.5)
        wb = (q.float() * scale).to(torch.bfloat16)
        for m in SEAM_MS:
            x = bf16(m, k)
            row = {}
            for prologue in (False, True):
                row["prologue_ms" if prologue else "ms"] = cs.time_ms(
                    lambda: qm.int8_matmul(x, q, scale, prologue))
            out["int8_matmul"][f"{name} M {m}"] = dict(
                **row, library_ms=cs.time_ms(lambda: torch.matmul(x, wb)),
                **cs.bound_fields(f"{name} M {m}",
                                  k * n + 4 * n + 2 * m * k + 2 * m * n,
                                  2 * m * k * n, cs.BF16_FLOPS))
    for m in SEAM_MS:
        calls = [out["int8_matmul"][f"{name} M {m}"]
                 for name, _, _ in cs.INT8_SEAMS]
        out["int8_matmul"][f"seams M {m}"] = {
            key: sum(c[key] for c in calls)
            for key in ("ms", "prologue_ms", "library_ms", "bound_ms")}
    if args.explore:
        out["explore"] = explore(torch, gen, dev, eps)
    print(cs.card_line())
    line = json.dumps(out)
    print(line)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    return 0


def profiled_ms(torch, call, n: int = 50) -> float:
    """The device time of ``call``'s kernels per call, as
    ``torch.profiler`` (CUPTI) reads it over ``n`` calls: the kernels'
    own durations, as the decode step's profile groups take them."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            call()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / 1e3 / n


def explore(torch, gen, dev, eps) -> dict:
    from k8s_dra_driver_tpu_torch.ops import _build, norms
    from k8s_dra_driver_tpu_torch.ops import quant_matmul as qm
    from k8s_dra_driver_tpu_torch.ops._device import sm_count

    sms = sm_count(dev)
    stream = torch.cuda.current_stream().cuda_stream
    res = {"int8_splits": {}, "rmsnorm_forms": {}}
    lib = qm._library()
    for name, k, n in cs.INT8_SEAMS:
        q = torch.randint(-127, 128, (k, n), generator=gen, device=dev,
                          dtype=torch.int8)
        scale = torch.rand((1, n), generator=gen, device=dev) / 1000
        x = torch.randn((8, k), generator=gen, device=dev).to(torch.bfloat16)
        y = torch.empty((8, n), dtype=torch.bfloat16, device=dev)
        row = {"plan": qm.plan(1, 8, n, k, sms).split}
        for split in qm.SWAP_SPLITS:
            if (k // 64) % split:
                continue
            part = torch.empty((split, 1, 8, n), dtype=torch.float32,
                               device=dev)

            def call():
                rc = lib.int8_matmul(x.data_ptr(), q.data_ptr(),
                                     scale.data_ptr(), y.data_ptr(),
                                     part.data_ptr(), 1, 8, n, k, split, 0,
                                     stream)
                _build.check(rc, f"int8_matmul split {split}")
            row[f"split {split}"] = cs.time_ms(call)
        res["int8_splits"][name] = row
    nlib = norms._library()
    for _, rows, d in cs.RMSNORM_SHAPES:
        x = torch.randn((rows, d), generator=gen, device=dev).to(
            torch.bfloat16)
        w = torch.randn((d,), generator=gen, device=dev).to(torch.bfloat16)
        y = torch.empty_like(x)
        slots = -(-d // norms.SLOT)
        # (label, cluster, threads)
        forms = [(f"cluster {c}" if c > 1 else "one CTA a row", c,
                  -(-(-(-slots // c)) // 32) * 32) for c in (1, 2, 4, 8)]
        row = {"plan": norms.plan(rows, d)._asdict()}
        for label, c, threads in forms:
            if threads > 1024:
                continue

            def call():
                rc = nlib.rmsnorm_forward(
                    x.data_ptr(), w.data_ptr(), y.data_ptr(), rows, d, 0, 0,
                    eps, c, threads, 1,
                    torch.cuda.current_stream().cuda_stream)
                _build.check(rc, f"rmsnorm {label}")
            row[label] = cs.time_ms(call)
            if rows <= 512:
                row[label + " (graph)"] = cs.graph_ms(torch, call)
                row[label + " (profiled)"] = profiled_ms(torch, call)
        res["rmsnorm_forms"][f"x[{rows},{d}]"] = row
    return res


if __name__ == "__main__":
    sys.exit(main())
