"""Greedy speculative decoding: draft proposes, target verifies.
Counterpart of ``k8s_dra_driver_tpu/models/speculative.py``.

Latency lever for serving: a small draft model runs k cheap
autoregressive steps, then the target scores all k proposals in ONE
forward (a T = k+1 window, parallel over positions), accepting the
longest matching prefix plus the target's own correction token. For
greedy decoding the output is identical to running the target alone —
acceptance only changes how many target forwards it takes. The guarantee
is exact under deterministic numerics (the CPU tests pin token
equality); on the card, bf16 reduction order differs between the window
(T=k+1, K3) and the incremental (T=1, K2) forwards, so a near-TIED
argmax can resolve differently — the caveat every batched-verification
implementation carries, negligible for trained models at temperature 0.

The reference runs the whole loop as one compiled program. Here the loop
over rounds is a host loop, and each round's arithmetic stays on the
device: the k+1 draft feeds, the verify window, the argmaxes, the
``cumprod`` match, the commit into ``out`` and both rewinds. The host
reads one scalar a round, the committed count, for the loop condition.
On a CUDA device the draft's T=1 step and the target's T=k+1 window are
each captured once as a CUDA graph on this call's caches and buffers
(:class:`~.step_graph.StepGraph`, as the engine's steps are) and replayed
every feed and every round; ``capture=False`` runs them eagerly, as the
CPU always does. Rewinding a cache after a partial acceptance is free:
attention masks on the query positions (the steps take them from the
device, never from ``lengths``), later writes overwrite in place, and the
rewind writes the cache's ``[B]`` ``lengths`` tensor in place, so the
caches a caller gets back (``return_caches``) carry the committed
length.

Single-sequence (B=1): acceptance lengths differ per sequence, and
the rewind below moves every row's length together. Composes with the
int8 weight/cache paths (same decode machinery underneath).
"""

from __future__ import annotations

import dataclasses
import statistics

import numpy as np
import torch

from .. import resolve_device
from .decode import _as_tokens, _forward_with_cache, _param_device, prefill
from .llama import LlamaConfig
from .moe import MoeConfig
from .step_graph import StepGraph

__all__ = ["speculative_generate"]


def _rewind(cache, length: torch.Tensor) -> None:
    """A cache rewind is just the per-sequence length vector: entries
    beyond it are masked in attention and overwritten by later writes —
    block tables are untouched (the paged pool keeps the same blocks).
    Written in place, so a captured step reading ``lengths`` sees it."""
    cache.lengths.copy_(length.to(cache.lengths.dtype).expand_as(
        cache.lengths))


def speculative_generate(
    target_params: dict,
    draft_params: dict,
    prompt,                       # [1, S]
    target_config: LlamaConfig,
    draft_config: LlamaConfig,
    max_new_tokens: int,
    k: int = 4,
    quantize_cache: bool = False,
    return_stats: bool = False,
    target_state=None,
    draft_cache=None,
    return_caches: bool = False,
    capture: bool = True,
    device=None,
    timed: bool = False,
):
    """Greedy generation via draft speculation; returns [1, S + N] int32
    tokens, or (tokens, stats) with ``return_stats`` — stats =
    {"rounds", "accepted", "acceptance_rate"}: acceptance_rate = accepted
    / (rounds * k) in [0, 1] (float32, as the reference computes it), and
    tokens-per-round ≈ accepted/rounds + 1 — the numbers that say whether
    ``k`` (and the draft) pay for themselves. The port adds
    ``compile_counts`` (``draft_step`` and ``verify_window``: 1 each, a
    capture on the card or a first use eagerly, as the engine counts its
    steps), ``graphs`` (CUDA graphs held) and ``capture_s`` (host seconds
    of the steps' warm-ups and captures, inside the call). ``timed`` (CUDA
    only) brackets every
    draft feed and verify window with CUDA events and adds their median
    device milliseconds, ``draft_step_ms`` and ``verify_window_ms``.

    ``k`` draft tokens are proposed per verification round. Requires the
    two configs to share a vocabulary. ``device`` defaults to CUDA, where
    both parameter dicts must already live; ``capture=False`` runs the
    steps eagerly there too, to compare the two.

    **Shared/COW prefix blocks.** ``target_state=(last_logits, cache)``
    and ``draft_cache`` let the caller start from caches prefilled via
    ``decode.prefill_cached`` over a shared paged pool, so a cached
    prompt prefix is reused instead of re-prefilled. This is safe
    against cached blocks by construction: every write this loop issues
    (draft proposals, verification windows, post-rewind overwrites)
    lands at positions >= len(prompt), and ``prefill_cached``'s
    copy-on-write rule guarantees mapped shared blocks only cover
    positions strictly below the first recomputed tail token — so a
    draft or verify write can never mutate a cached block; it always
    hits a private (COW-materialized or freshly allocated) one. The
    caches must span ``s + max_new_tokens + k + 1`` positions.
    ``return_caches`` appends the final ``(target_cache, draft_cache)``
    to the return value (the cached-block-immutability regression test
    checksums pool rows through it).
    """
    dev = resolve_device(device)
    if timed and dev.type != "cuda":
        raise ValueError("timed: CUDA events need a CUDA device")
    for name, params in (("target", target_params), ("draft", draft_params)):
        if _param_device(params).type != dev.type:
            raise ValueError(f"{name} params live on "
                             f"{_param_device(params)}, not on {dev}")
    prompt = _as_tokens(prompt, _param_device(target_params))
    b, s = prompt.shape
    if b != 1:
        raise ValueError(
            f"speculative decoding rewinds one sequence's cache (B=1); got B={b}"
        )
    if target_config.vocab_size != draft_config.vocab_size:
        raise ValueError(
            "target and draft must share a vocabulary: "
            f"{target_config.vocab_size} != {draft_config.vocab_size}"
        )
    # Headroom: a round may write k+1 positions beyond the committed
    # length before rewinding.
    max_len = s + max_new_tokens + k + 1

    # The verify window must reproduce the target's T=1 decode. MoE
    # capacity routing is capacity-immune at T=1 (a lone token always
    # fits its experts' slots) but a T=k+1 window can overflow
    # per-expert capacity and drop tokens the incremental target never
    # would — silently changing outputs at the default capacity_factor.
    # Dropless dispatch restores the T=1 ROUTING semantics at any window
    # width: the same experts fire with the same gates, so the guarantee
    # is equivalence up to matmul reduction order. Prefill keeps the
    # caller's config: generate()'s own prefill uses it too, so the two
    # paths stay comparable from the same starting state.
    verify_config = (
        dataclasses.replace(target_config, moe_impl="dropless")
        if isinstance(target_config, MoeConfig)
        else target_config
    )

    if target_state is None:
        logits_t, cache_t = prefill(
            target_params, prompt, target_config, max_len,
            quantize_cache=quantize_cache,
        )
    else:
        logits_t, cache_t = target_state
        if cache_t.max_len < max_len:
            raise ValueError(
                f"target cache spans {cache_t.max_len} positions but the "
                f"run needs {max_len} (= s + max_new_tokens + k + 1)"
            )
    if draft_cache is None:
        _, cache_d = prefill(
            draft_params, prompt, draft_config, max_len,
            quantize_cache=quantize_cache,
        )
    else:
        cache_d = draft_cache
        if cache_d.max_len < max_len:
            raise ValueError(
                f"draft cache spans {cache_d.max_len} positions but the "
                f"run needs {max_len} (= s + max_new_tokens + k + 1)"
            )
    pdev = prompt.device
    first = logits_t.argmax(dim=-1).to(torch.int32)            # [1]

    width = max_new_tokens + k + 1
    out = torch.zeros((1, width), dtype=torch.int32, device=pdev)
    out[:, 0] = first
    idx = torch.arange(width, device=pdev)
    offsets = torch.arange(k, device=pdev)
    window = torch.arange(k + 1, device=pdev)
    # ``live`` is 1 in every real feed; a StepGraph's warm-ups run on
    # zeroed inputs, whose rows are inactive and so write only the
    # pools' scratch row.
    live = torch.ones((1,), dtype=torch.int32, device=pdev)

    # Attention masks on the positions fed, so neither step reads
    # ``lengths``; the round's rewind writes them.
    def draft_fn(tok, pos, on):
        # tok [1], pos [1]: the fed token and its position.
        logits, _ = _forward_with_cache(
            draft_params, tok[:, None], cache_d, draft_config, pos,
            active=on != 0,
        )
        return logits[:, 0].argmax(dim=-1).to(torch.int32)

    def verify_fn(chunk, start, on):
        # chunk [1, k+1] from position ``start`` [1].
        logits, _ = _forward_with_cache(
            target_params, chunk, cache_t, verify_config,
            start + window, active=on != 0,
        )
        return logits[0].argmax(dim=-1).to(torch.int32)        # [k+1]

    counts = {"draft_step": 0, "verify_window": 0}
    draft = StepGraph(draft_fn, pdev, counts=counts, name="draft_step",
                      capture=capture)
    verify = StepGraph(verify_fn, pdev, counts=counts, name="verify_window",
                       capture=capture)

    n_dev = torch.ones((1,), dtype=torch.int32, device=pdev)
    pending = first.clone()
    proposals = torch.empty((k + 1,), dtype=torch.int32, device=pdev)
    n, rounds = 1, 0
    spans = {"draft_step": [], "verify_window": []}

    def run(step, name, *tensors):
        if not timed:
            return step((), *tensors)
        start, end = (torch.cuda.Event(enable_timing=True)
                      for _ in range(2))
        start.record()
        out = step((), *tensors)
        end.record()
        spans[name].append((start, end))
        return out

    while n < max_new_tokens:
        # Committed tokens so far: prompt (s) + n generated; ``pending``
        # is the last of them, not yet in either cache.
        start = n_dev + (s - 1)                                 # m - 1
        # Draft proposes g_1..g_k (one extra feed keeps its cache long
        # enough for a full acceptance; the k+1-th proposal is unused).
        tok, pos = pending, start
        for i in range(k + 1):
            tok = run(draft, "draft_step", tok, pos, live)
            proposals[i:i + 1].copy_(tok)
            pos = pos + 1
        g = proposals[:k]

        # Target verifies the whole window in one forward.
        chunk = torch.cat([pending, g])[None, :]               # [1, k+1]
        y = run(verify, "verify_window", chunk, start, live)

        # Longest matching prefix: g[i] must equal y[i] (the target's
        # token after consuming the i-th fed token).
        a = torch.cumprod((g == y[:k]).to(torch.int32), 0).sum()
        # y_a by gather: indexing with the device scalar would read it on
        # the host.
        y_a = y.index_select(0, a.reshape(1))                  # [1]
        # Commit g_1..g_a then the target's correction y_a.
        accept = (idx >= n_dev) & (idx < n_dev + a)
        src = torch.zeros_like(out[0]).scatter_(
            0, (n_dev + offsets).clamp(0, width - 1), g)
        row = torch.where(accept, src, out[0])
        row.scatter_(0, n_dev + a, y_a)
        out[0].copy_(row)

        # Rewind both caches to the committed length minus the pending
        # token (the new pending is y_a, fed next round).
        _rewind(cache_t, start + 1 + a)
        _rewind(cache_d, start + 1 + a)
        pending = y_a
        n_dev += a + 1
        rounds += 1
        n = int(n_dev.item())          # the round's one host sync
    tokens = torch.cat([prompt, out[:, :max_new_tokens]], dim=1)
    result = [tokens]
    if return_stats:
        # Each round commits its accepted drafts and one correction.
        accepted = n - 1 - rounds
        result.append({
            "rounds": rounds,
            "accepted": accepted,
            "acceptance_rate": float(
                np.float32(accepted) / np.float32(max(rounds * k, 1))),
            "compile_counts": dict(counts),
            "graphs": draft.graphs + verify.graphs,
            "capture_s": draft.build_s + verify.build_s,
        })
        if timed:
            torch.cuda.synchronize(dev)
            for name, pairs in spans.items():
                result[-1][name + "_ms"] = statistics.median(
                    a.elapsed_time(b) for a, b in pairs)
    if return_caches:
        result.append((cache_t, cache_d))
    return result[0] if len(result) == 1 else tuple(result)
