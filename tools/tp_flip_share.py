#!/usr/bin/env python3
"""What sets the routing flips of int8 Mixtral-8x7B on a tensor-4 mesh
against the single device (chip_smoke phase 35's logits hold), on one GPU:

    python3 tools/tp_flip_share.py [--out FILE]

Phase 35's model (``chip_smoke.int8_moe_params``: 32 layers, int8 weights)
prefills chip_smoke's seeded TP_LOGITS_PROMPT-token prompts and decodes
TP_LOGITS_DECODE steps once on the single device (the primitive path, its
expert choices recorded) and then on ``MeshConfig(tensor=T)`` with those
choices replayed, for each entry of ``RUNS`` (the int8 KV cache or the
bf16 one; T 4 or 1) in up to three ways:

- ``bf16_partials``: as the port runs it. Each tensor shard's partial
  product of a row-parallel weight (``wo``'s row block, the experts'
  ``w_down`` blocks) comes out of its kernel rounded to bf16 before the
  f32 psum.
- ``f32_partials``: those partial products computed in f32 and summed
  unrounded (the plain product of the int8 weight, f32 sums, times its
  scale); every other product as the port runs it. Where the flips come
  from the partials' bf16 rounding, they fall here.
- ``dropped_shard``: a fault. Tensor shard 1's ``w_down`` partial is
  replaced by zeros in every MoE layer, as a psum that lost a shard
  would leave it.

For each: the routing flips (a token-layer whose own top-2 differs from
the recorded one), their share of the routed choices and largest margin,
and the logits' largest difference relative to the single device's
largest magnitude, prefill and each decode step. Nothing is held to a
limit: the readings sit beside chip_smoke's TP_FLIP_SHARE_LIMIT.

Prints the card's name and power limit, then one JSON line (also written
to ``--out``)."""

import argparse
import contextlib
import dataclasses
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from k8s_dra_driver_tpu_torch.parallel import shard_pytree  # noqa: E402


@contextlib.contextmanager
def partials(mode: str, cfg, tp: int):
    """Patches the row-parallel products of the mesh run (their contracted
    axis a tensor shard's block, so the single device's whole-width
    products pass through): ``f32_partials`` returns them in f32,
    ``dropped_shard`` zeroes shard 1's expert down products."""
    from k8s_dra_driver_tpu_torch.models import decode
    from k8s_dra_driver_tpu_torch.models.quant import QuantTensor
    from k8s_dra_driver_tpu_torch.ops import moe_dispatch as md

    q_matmul, grouped = decode.q_matmul, md.grouped_matmul
    wo_rows = cfg.n_heads * cfg.head_dim // tp
    down_rows = cfg.mlp_hidden // tp
    calls = [0]

    def f32_q_matmul(x, w, use_kernels=True):
        if isinstance(w, QuantTensor) and w.q.shape[0] == wo_rows:
            return (x.float() @ w.q.float()) * w.scale
        return q_matmul(x, w, use_kernels)

    def patched_grouped(lhs, rhs, group_sizes, *, use_kernels=True):
        if not (isinstance(rhs, QuantTensor) and rhs.q.dim() == 3
                and rhs.q.shape[1] == down_rows):
            return grouped(lhs, rhs, group_sizes, use_kernels=use_kernels)
        if mode == "dropped_shard":
            # A layer calls shards 0..tp-1 in order.
            shard = calls[0] % tp
            calls[0] += 1
            out = grouped(lhs, rhs, group_sizes, use_kernels=use_kernels)
            return torch.zeros_like(out) if shard == 1 else out
        y = md.grouped_matmul_reference(lhs.float(), rhs.q.float(),
                                        group_sizes)
        return y * md._row_scale(rhs.scale, group_sizes, lhs.shape[0])

    if mode == "f32_partials":
        decode.q_matmul = f32_q_matmul
    if mode != "bf16_partials":
        md.grouped_matmul = patched_grouped
    try:
        yield
    finally:
        decode.q_matmul, md.grouped_matmul = q_matmul, grouped


def run(params, toks, cfg, m, n, quantize_cache: bool):
    """Prefill then decode on ``m`` (None: the single device): each step's
    f32 logits."""
    from k8s_dra_driver_tpu_torch.models.decode import decode_step, prefill

    logits, cache = prefill(params, toks[:, :cs.TP_LOGITS_PROMPT], cfg,
                            n + 1, quantize_cache=quantize_cache,
                            block_size=cs.BLOCK_SIZE, mesh=m)
    seq = [logits.float()]
    for i in range(cs.TP_LOGITS_PROMPT, n):
        logits, cache = decode_step(params, toks[:, i], cache, cfg, mesh=m)
        seq.append(logits.float())
    return seq


def measure(params, cfg, dev, runs) -> dict:
    """The readings (see the module docstring) of ``cfg`` (dropless) with
    ``params`` on the single device and placed on ``MeshConfig(tensor=
    tp)`` of ``dev``, for each ``(quantize_cache, tp, modes)`` of
    ``runs``."""
    from k8s_dra_driver_tpu_torch.models import moe
    from k8s_dra_driver_tpu_torch.models.quant import quantize_specs

    gen = torch.Generator(device=dev)
    gen.manual_seed(cs.SEED + 50)              # chip_smoke's mesh_logits_rel
    n = cs.TP_LOGITS_PROMPT + cs.TP_LOGITS_DECODE
    toks = torch.randint(0, cfg.vocab_size, (cs.BATCH_SLOTS, n),
                         generator=gen, device=dev, dtype=torch.int32)
    specs = quantize_specs(moe.param_specs(cfg))
    out = {}
    for quantize_cache, tp, modes in runs:
        mesh = cs.card_mesh(dev, tensor=tp)
        sharded = shard_pytree(params, mesh, specs)
        with torch.no_grad(), cs.RoutingReplay(moe) as replay:
            replay.mode = "record"
            with cs.primitive_dispatch():
                single = run(params, toks, cfg, None, n, quantize_cache)
            recorded = list(replay.recorded)
            for mode in modes:
                t0 = time.perf_counter()
                replay.recorded = list(recorded)
                replay.margins, replay.routed = [], 0
                replay.mode = "replay"
                with partials(mode, cfg, tp):
                    meshed = run(sharded, toks, cfg, mesh, n, quantize_cache)
                rels = [((a - b).abs().max() / b.abs().max()).item()
                        for a, b in zip(meshed, single)]
                summary = replay.summary()
                margins = summary.pop("flip_margins")
                key = (f"{'int8' if quantize_cache else 'bf16'} cache, "
                       f"tensor {tp}, {mode}")
                out[key] = dict(
                    summary, flip_share=(summary["routing_flips"] / max(
                        summary["routed_token_layers"], 1)),
                    flip_margin_median=(margins[len(margins) // 2]
                                        if margins else 0.0),
                    prefill_rel=rels[0], decode_rel=rels[1:],
                    seconds=time.perf_counter() - t0)
                print(f"tp_flip_share {key}: {json.dumps(out[key])}",
                      flush=True)
    return out


#: (int8 KV cache, tensor, partial modes): phase 35's setting three ways;
#: the bf16 cache (no per-run quantization of k and v); one tensor shard
#: (the mesh's code path without a split).
RUNS = ((True, 4, ("bf16_partials", "f32_partials", "dropped_shard")),
        (False, 4, ("bf16_partials", "f32_partials")),
        (True, 1, ("bf16_partials",)))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("tp_flip_share: no CUDA device", file=sys.stderr)
        return 2
    from k8s_dra_driver_tpu_torch.models import MOE_PRESETS

    dev = torch.device("cuda")
    cfg = dataclasses.replace(MOE_PRESETS["8x7b"], moe_impl="dropless")
    params = cs.int8_moe_params(torch, MOE_PRESETS["8x7b"], dev)
    out = {"model": "8x7b int8", "share_limit": cs.TP_FLIP_SHARE_LIMIT,
           "margin_limit": cs.FLIP_MARGIN_LIMIT_KVQ,
           "logits_rel_limit": cs.TP_LOGITS_REL,
           **measure(params, cfg, dev, RUNS)}
    print(cs.card_line())
    line = json.dumps(out)
    print(line)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
