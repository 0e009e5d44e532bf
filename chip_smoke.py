#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Drives ``k8s_dra_driver_tpu_torch`` -- no JAX -- through its serving path
at the full width and depth of Llama-3-8B (bf16, random weights from a
fixed seed) and checks every hand-written kernel of that path:

1. builds the CUDA sources of ``k8s_dra_driver_tpu_torch/csrc`` (one
   ``nvcc`` per source, all started together) and the Triton RMSNorm;
2. holds each kernel against its plain PyTorch version on the same inputs
   at the main path's shapes, and times kernel, plain version and (where
   one PyTorch call computes the same function) that call;
3. runs one 8B forward -- a prefill chunk, then decode steps -- through the
   kernels and through the plain versions, and compares the logits;
4. serves 8 requests (prompts of 96 to 700 tokens, four sharing a
   256-token prefix, 32 new tokens each) through ``DecodeEngine`` with the
   prefix cache and the overlapped tick on, with every kernel's launch
   count set to 0 just before and read just after.

Prints the card's name and power limit, one ``{"kernels": [...]}`` line,
the engine's metrics, and as its last line
``{"ok": true, "device": {...}}``. Any failed check raises: the script
then exits nonzero without that line. It also exits nonzero, printing no
result, where no CUDA device is present or the package is missing.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM published peaks (NVIDIA data sheet), for the bounds below.
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12

SEED = 0
BLOCK_SIZE = 16
NUM_BLOCKS = 1024
BATCH_SLOTS = 8
PREFILL_CHUNK = 128
PREFILL_BATCH = 4
NEW_TOKENS = 32
PREFIX_LEN = 256


def log(*parts) -> None:
    print(*parts, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    if not out:
        raise RuntimeError("nvidia-smi printed no card")
    return out


_FLUSH = []


def time_ms(fn, warmup: int = 3, iters: int = 20) -> float:
    """Median device milliseconds of one ``fn()`` call (CUDA events).

    Before each call a 256 MB write evicts the 50 MB L2, as the engine's
    layer loop does (each layer reads other weights and other pools), and
    keeps the card busy while the host enqueues the timed launch, so the
    host's launch latency stays outside the timed span."""
    import torch

    if not _FLUSH:
        _FLUSH.append(torch.empty(64 << 20, dtype=torch.float32,
                                  device="cuda"))
    for _ in range(warmup):
        fn()
    pairs = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        _FLUSH[0].zero_()
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def bound(bytes_moved: float, flops: float, peak_flops: float):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def paged_inputs(torch, gen, dev, lens_needed, nbps, hkv, d):
    """Random pools for one layer of the engine's pool and block tables
    whose first ceil(n / bs) entries are distinct random blocks."""
    p = NUM_BLOCKS * BLOCK_SIZE
    k = torch.randn((hkv, p + 1, d), generator=gen, device=dev).to(
        torch.bfloat16)
    v = torch.randn((hkv, p + 1, d), generator=gen, device=dev).to(
        torch.bfloat16)
    perm = torch.randperm(NUM_BLOCKS, generator=gen, device=dev).to(
        torch.int32)
    tables = torch.zeros((len(lens_needed), nbps), dtype=torch.int32,
                         device=dev)
    used = 0
    for i, n in enumerate(lens_needed):
        nb = -(-n // BLOCK_SIZE)
        tables[i, :nb] = perm[used:used + nb]
        used += nb
    if used > NUM_BLOCKS:
        raise RuntimeError("test windows exceed the pool")
    return k, v, tables


def check_kernels(torch, cfg, dev) -> dict:
    """Phase 2: each kernel against its plain version at main-path shapes."""
    from k8s_dra_driver_tpu_torch.ops import attention as att
    from k8s_dra_driver_tpu_torch.ops import norms

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    hq, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    nbps = cfg.max_seq_len // BLOCK_SIZE
    scale = d ** -0.5
    results = {}

    def attn_errors(out, ref, name):
        err = (out.float() - ref.float()).abs()
        max_err, mean_err = err.max().item(), err.mean().item()
        finite = bool(torch.isfinite(out.float()).all())
        log(f"{name}: max_abs_err={max_err:.3e} mean_abs_err="
            f"{mean_err:.3e} finite={finite}")
        if not finite or max_err > 2e-2 or mean_err > 2e-3:
            raise AssertionError(
                f"{name} disagrees with its plain version: max {max_err} "
                f"(limit 2e-2), mean {mean_err} (limit 2e-3)")
        return max_err

    # K2: one decode step of the engine run (batch 8, the prompts plus
    # their generated tokens).
    vlen_list = [96 + 32, 180 + 32, 300 + 32, 700 + 32, 320 + 32, 406 + 32,
                 700 + 1, 256 + 16]
    k, v, tables = paged_inputs(torch, gen, dev, vlen_list, nbps, hkv, d)
    q = torch.randn((BATCH_SLOTS, hq, d), generator=gen, device=dev).to(
        torch.bfloat16)
    vlen = torch.tensor(vlen_list, dtype=torch.int32, device=dev)
    out = att.paged_decode_attention(q, k, v, tables, vlen, BLOCK_SIZE, scale)
    ref = att.paged_attention_reference(
        q[:, :, None], k, v, tables, (vlen.long() - 1)[:, None], BLOCK_SIZE,
        scale)[:, :, 0]
    torch.cuda.synchronize()
    err = attn_errors(out, ref, "paged_decode")
    s = sum(vlen_list)
    t_b, by = bound(
        s * hkv * d * 2 * 2 + 2 * q.numel() * 2
        + sum(-(-n // BLOCK_SIZE) for n in vlen_list) * 4,
        s * hq * d * 4, BF16_FLOPS)
    results["paged_decode"] = dict(
        max_abs_err=err,
        ms=time_ms(lambda: att.paged_decode_attention(
            q, k, v, tables, vlen, BLOCK_SIZE, scale)),
        plain_ms=time_ms(lambda: att.paged_attention_reference(
            q[:, :, None], k, v, tables, (vlen.long() - 1)[:, None],
            BLOCK_SIZE, scale)),
        bound_ms=t_b, bound_by=by, library_ms=None,
        shape=f"q[{BATCH_SLOTS},{hq},{d}] valid_len sum {s}",
    )

    # K3: one packed prefill launch (4 lanes x 128 tokens), windows from
    # position 0, after a 256-token prefix hit, mid-prompt, and the
    # straddling last chunk of a 700-token prompt.
    t = PREFILL_CHUNK
    starts_list = [0, 256, 384, 572]
    k, v, tables = paged_inputs(torch, gen, dev,
                                [s0 + t for s0 in starts_list], nbps, hkv, d)
    q = torch.randn((PREFILL_BATCH, hq, t, d), generator=gen,
                    device=dev).to(torch.bfloat16)
    pos = (torch.tensor(starts_list, device=dev)[:, None]
           + torch.arange(t, device=dev)[None, :])
    out = att.paged_prefill_attention(q, k, v, tables, pos, BLOCK_SIZE, scale)
    ref = att.paged_attention_reference(q, k, v, tables, pos, BLOCK_SIZE,
                                        scale)
    torch.cuda.synchronize()
    err = attn_errors(out, ref, "paged_prefill")
    visible = sum(s0 + i + 1 for s0 in starts_list for i in range(t))
    t_b, by = bound(
        sum(s0 + t for s0 in starts_list) * hkv * d * 2 * 2
        + 2 * q.numel() * 2,
        visible * hq * d * 4, BF16_FLOPS)
    results["paged_prefill"] = dict(
        max_abs_err=err,
        ms=time_ms(lambda: att.paged_prefill_attention(
            q, k, v, tables, pos, BLOCK_SIZE, scale)),
        plain_ms=time_ms(lambda: att.paged_attention_reference(
            q, k, v, tables, pos, BLOCK_SIZE, scale)),
        bound_ms=t_b, bound_by=by, library_ms=None,
        shape=f"q[{PREFILL_BATCH},{hq},{t},{d}] starts {starts_list}",
    )

    # K1: the prefill chunk's norm input [4, 128, 4096].
    x = torch.randn((PREFILL_BATCH, t, cfg.hidden), generator=gen,
                    device=dev).to(torch.bfloat16)
    w = (1 + 0.1 * torch.randn((cfg.hidden,), generator=gen,
                               device=dev)).to(torch.bfloat16)
    eps = cfg.norm_eps
    out = norms.rmsnorm(x, w, eps)
    ref = norms.rmsnorm_reference(x, w, eps)
    torch.cuda.synchronize()
    diff = (out.float() - ref.float()).abs()
    rel = (diff.max() / ref.float().abs().max()).item()
    log(f"rmsnorm: max_abs_err={diff.max().item():.3e} rel_err={rel:.3e}")
    if not bool(torch.isfinite(out.float()).all()) or rel > 1e-2:
        raise AssertionError(f"rmsnorm rel error {rel} (limit 1e-2)")
    rows = x.numel() // cfg.hidden
    t_b, by = bound(2 * x.numel() * 2 + w.numel() * 2,
                    4 * x.numel(), F32_FLOPS)
    lib = getattr(torch.nn.functional, "rms_norm", None)
    results["rmsnorm"] = dict(
        max_abs_err=diff.max().item(),
        ms=time_ms(lambda: norms.rmsnorm(x, w, eps)),
        plain_ms=time_ms(lambda: norms.rmsnorm_reference(x, w, eps)),
        bound_ms=t_b, bound_by=by,
        library_ms=(time_ms(lambda: lib(x, (cfg.hidden,), w, eps))
                    if lib is not None else None),
        shape=f"x[{rows},{cfg.hidden}]",
    )
    return results


def compare_forward(torch, params, cfg, dev) -> dict:
    """Phase 3: one 8B forward through the kernels and through the plain
    versions, on identical caches and tokens."""
    from k8s_dra_driver_tpu_torch.models.decode import _forward_with_cache
    from k8s_dra_driver_tpu_torch.models.paged import PagedKVCache

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 1)
    b, t, steps = 2, PREFILL_CHUNK, 4
    caches = {
        flag: PagedKVCache.init(cfg, b, 512, block_size=BLOCK_SIZE,
                                device=dev)
        for flag in (True, False)
    }
    tokens = torch.randint(0, cfg.vocab_size, (b, t), generator=gen,
                           device=dev, dtype=torch.int32)
    positions = torch.arange(t, device=dev)
    worst, agree, total, rel = 0.0, 0, 0, 0.0
    for step in range(steps + 1):
        logits = {}
        for flag in (True, False):
            logits[flag], caches[flag] = _forward_with_cache(
                params, tokens, caches[flag], cfg, positions,
                use_kernels=flag)
        a, p = logits[True][:, -1], logits[False][:, -1]
        if not bool(torch.isfinite(a).all()):
            raise AssertionError(f"non-finite logits at step {step}")
        worst = max(worst, (a - p).abs().max().item())
        rel = max(rel, ((a - p).norm() / p.norm()).item())
        agree += int((a.argmax(-1) == p.argmax(-1)).sum())
        total += b
        tokens = a.argmax(-1).to(torch.int32)[:, None]
        positions = caches[True].lengths[:, None]
    result = dict(max_logit_diff=worst, rel_logit_diff=rel,
                  top1_agreement=agree / total, positions_compared=total)
    log("forward kernels vs plain:", json.dumps(result))
    if rel > 5e-2:
        raise AssertionError(f"8B forward: relative logit difference {rel} "
                             f"(limit 5e-2)")
    return result


def serve(torch, params, cfg, dev) -> dict:
    """Phase 4: the engine run (the main path)."""
    from k8s_dra_driver_tpu_torch.models import DecodeEngine
    from k8s_dra_driver_tpu_torch.models.serving import RUNNING

    rng = torch.Generator()
    rng.manual_seed(SEED + 2)

    def toks(n):
        return torch.randint(0, cfg.vocab_size, (n,), generator=rng).tolist()

    prefix = toks(PREFIX_LEN)
    first = [toks(96), toks(180), toks(300), toks(700), prefix + toks(64)]
    later = [prefix + toks(150), prefix + toks(444), list(prefix)]
    eng = DecodeEngine(
        params, cfg, batch_slots=BATCH_SLOTS, num_blocks=NUM_BLOCKS,
        block_size=BLOCK_SIZE, prefill_chunk=PREFILL_CHUNK,
        prefill_batch=PREFILL_BATCH, prefix_cache=True, overlap=True,
        device=dev,
    )
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reqs = [eng.submit(p, max_new_tokens=NEW_TOKENS) for p in first]
    # The shared-prefix family arrives once the first holder of the
    # prefix has prefilled it (so the radix index can serve it).
    for _ in range(10000):
        if reqs[-1].state == RUNNING or reqs[-1].done:
            break
        eng.tick()
    else:
        raise AssertionError("the first shared-prefix request never ran")
    reqs += [eng.submit(p, max_new_tokens=NEW_TOKENS) for p in later]
    eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    eng.assert_no_leaks()
    st = eng.stats
    bad = [(r.rid, len(r.generated)) for r in reqs
           if not r.done or len(r.generated) != NEW_TOKENS]
    if len(reqs) != 8 or bad:
        raise AssertionError(f"requests not finished with {NEW_TOKENS} "
                             f"tokens: {bad}")
    if st.prefix_hits <= 0 or st.cow_recomputes <= 0:
        raise AssertionError(f"prefix hits {st.prefix_hits}, COW "
                             f"recomputes {st.cow_recomputes}")
    for r in reqs:
        if not all(0 <= x < cfg.vocab_size for x in r.generated):
            raise AssertionError(f"request {r.rid}: token out of range")
    metrics = dict(
        requests=len(reqs),
        prompt_lens=[len(r.prompt) for r in reqs],
        tokens_generated=st.tokens_generated,
        wall_s=wall,
        tokens_per_s=st.tokens_generated / wall,
        ttft_p50_ms=st.p50_ttft_ms(), ttft_p99_ms=st.p99_ttft_ms(),
        decode_step_p50_ms=st.p50_token_ms(),
        decode_steps=st.decode_steps, prefill_chunks=st.prefill_chunks,
        prefix_hits=st.prefix_hits, prefix_hit_tokens=st.prefix_hit_tokens,
        cow_recomputes=st.cow_recomputes, preemptions=st.preemptions,
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
    )
    log("engine:", json.dumps(metrics))
    return metrics


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        from k8s_dra_driver_tpu_torch.models import PRESETS, init_params
        from k8s_dra_driver_tpu_torch.ops import _build, attention, norms
    except ImportError as e:
        print(f"chip_smoke: the port package is missing: {e}",
              file=sys.stderr)
        return 2
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = card_line()
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on "
        f"{torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    _build.build()
    log(f"phase 1: built {_build.sources()} in "
        f"{time.perf_counter() - t0:.1f}s")
    for name, text in _build.BUILD_LOGS.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                log(f"  {name}: {line.strip()}")

    cfg = PRESETS["8b"]
    kernels = check_kernels(torch, cfg, dev)
    log("phase 2: kernels agree with their plain versions")

    t0 = time.perf_counter()
    params = init_params(cfg, seed=SEED, device=dev)
    torch.cuda.synchronize()
    log(f"8b params ({cfg.num_params() / 1e9:.2f}B) initialised in "
        f"{time.perf_counter() - t0:.1f}s")
    forward = compare_forward(torch, params, cfg, dev)
    log("phase 3: 8B forward through kernels matches the plain forward")

    wrappers = {
        "paged_decode": attention.paged_decode_attention,
        "paged_prefill": attention.paged_prefill_attention,
        "rmsnorm": norms.rmsnorm,
    }
    for fn in wrappers.values():
        fn.launches = 0
    engine = serve(torch, params, cfg, dev)
    launches = {name: fn.launches for name, fn in wrappers.items()}
    missing = [name for name, n in launches.items() if n <= 0]
    if missing:
        raise AssertionError(f"main path never launched {missing}")
    log("phase 4: engine served 8 requests through every kernel")

    meta = {
        "paged_decode": ("cuda", "k8s_dra_driver_tpu_torch/csrc/"
                         "paged_attention.cu",
                         "k8s_dra_driver_tpu/ops/attention.py:618"),
        "paged_prefill": ("cuda", "k8s_dra_driver_tpu_torch/csrc/"
                          "paged_attention.cu",
                          "k8s_dra_driver_tpu/ops/attention.py:772"),
        "rmsnorm": ("triton", "k8s_dra_driver_tpu_torch/ops/norms.py",
                    "k8s_dra_driver_tpu/ops/norms.py:26"),
    }
    rows = []
    for name, (route, source, replaces) in meta.items():
        k = kernels[name]
        rows.append(dict(
            name=name, route=route, source=source, replaces=replaces,
            launches=launches[name], max_abs_err=k["max_abs_err"],
            ms=k["ms"], plain_ms=k["plain_ms"], bound_ms=k["bound_ms"],
            bound_by=k["bound_by"], library_ms=k["library_ms"],
            # kernel_ms and max_err repeat ms and max_abs_err under a
            # second pair of names, both read by the port's records.
            kernel_ms=k["ms"], max_err=k["max_abs_err"], shape=k["shape"],
        ))
    for row in rows:
        for key in ("ms", "plain_ms", "bound_ms", "max_abs_err"):
            if not math.isfinite(row[key]):
                raise AssertionError(f"{row['name']}: {key} not finite")
    log(card)
    log(json.dumps({"forward": forward, "engine": engine}))
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
