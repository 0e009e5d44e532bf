"""Time the remat sites of ``models/remat.py`` against the plain autograd
expressions they replace, forward and backward, at the 8b-L8 training
shapes (batch 8 x 2048, Llama-3-8B widths) on the card.

Each row is the median of CUDA-event timings of one forward plus one
backward (``torch.autograd.grad``) of: the site op as the model calls it,
and the same function written as plain PyTorch under autograd (the form
the model ran before the sites). Gradients of the two are compared too
(largest difference over the plain one's largest magnitude).

    python3 tools/remat_sites.py [--iters N]
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

B, T, H, M = 8, 2048, 4096, 14336
HQ, HKV, D = 32, 8, 128


def timed(torch, fn, iters: int) -> float:
    for _ in range(2):
        fn()
    pairs = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def compare(torch, site, plain, inputs, grad_out, iters: int) -> dict:
    """fwd+bwd ms of ``site`` and ``plain`` on the same inputs, and their
    gradients' largest relative difference."""

    def run(fn):
        leaves = [x.detach().requires_grad_() for x in inputs]
        out = fn(*leaves)
        outs = out if isinstance(out, tuple) else (out,)
        return torch.autograd.grad(outs, leaves, grad_out)

    a, b_ = run(site), run(plain)
    diff = max(((x.float() - y.float()).abs().max()
                / y.float().abs().max().clamp(min=1e-30)).item()
               for x, y in zip(a, b_))
    return dict(site_ms=timed(torch, lambda: run(site), iters),
                plain_ms=timed(torch, lambda: run(plain), iters),
                grad_rel_diff=diff)


def main() -> int:
    import torch
    import torch.nn.functional as F

    parser = argparse.ArgumentParser()
    parser.add_argument("--iters", type=int, default=10)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("remat_sites: no CUDA device", file=sys.stderr)
        return 2
    from k8s_dra_driver_tpu_torch.models.remat import (
        attn_proj_site,
        qkv_site,
        swiglu_site,
    )
    from k8s_dra_driver_tpu_torch.ops.rotary import (
        apply_rope,
        rope_frequencies,
    )

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    bf16 = torch.bfloat16

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev)
                * scale).to(bf16)

    g = HQ // HKV
    cos, sin = rope_frequencies(D, T, 500000.0, device=dev)

    def plain_qkv(xn, w):
        qkv = (xn @ w.reshape(H, -1)).reshape(B, T, HKV, g + 2, D)
        q = qkv[..., :g, :].reshape(B, T, HQ, D)
        q = apply_rope(q.transpose(1, 2), cos, sin)
        k = apply_rope(qkv[..., g, :].transpose(1, 2), cos, sin)
        return q, k, qkv[..., g + 1, :].transpose(1, 2)

    def plain_proj(o, wo):
        return o.transpose(1, 2).reshape(B, T, -1) @ wo

    def plain_swiglu(gu):
        return (F.silu(gu[..., 0, :].float())
                * gu[..., 1, :].float()).to(gu.dtype)

    rows = {
        "project_qkv": compare(
            torch, lambda xn, w: qkv_site(xn, w, cos, sin), plain_qkv,
            (randn(B, T, H), randn(H, HKV, g + 2, D, scale=H ** -0.5)),
            (randn(B, HQ, T, D), randn(B, HKV, T, D), randn(B, HKV, T, D)),
            args.iters),
        "attn_proj": compare(
            torch, attn_proj_site, plain_proj,
            (randn(B, HQ, T, D), randn(HQ * D, H, scale=H ** -0.5)),
            (randn(B, T, H),), args.iters),
        "swiglu": compare(
            torch, swiglu_site, plain_swiglu, (randn(B, T, 2, M),),
            (randn(B, T, M),), args.iters),
    }
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
    ).stdout.strip()
    print(card)
    print(json.dumps({"remat_sites": rows, "shape": dict(
        batch=B, seq=T, hidden=H, mlp=M, heads=HQ, kv_heads=HKV,
        head_dim=D)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
