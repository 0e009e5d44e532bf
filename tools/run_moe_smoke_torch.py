#!/usr/bin/env python3
"""Fast fixed-seed MoE smoke on the PyTorch port.

Twin of ``tools/run_moe_smoke.py`` (``make moebench``) over
``k8s_dra_driver_tpu_torch.models.moe``: the same gates, seed, tokens,
``TPU_DRA_MOE_SMOKE_*`` variables, printed lines and exit codes, with
the ``tiny-moe`` preset on the CPU (Mixtral-8x7B's widths at one layer
on the card, ``_gate_torch.moe_preset``):

1. **Compile-once**: running the train step (loss and gradients) and the
   forward again with identical shapes adds no MoE block key to
   ``moe.MOE_TRACE_COUNTS`` (the port counts each (impl, dispatch,
   token-count) key at its first use, where the reference counts traces).
2. **Impl parity**: at drop-free capacity, einsum / binned / dropless
   compute the same function, and the FUSED dropless dispatch (K7/K8,
   ``ops/moe_dispatch.py``; their plain versions on the CPU) matches the
   primitive gather + grouped-matmul path (K10a on the card).
3. **Auto policy**: ``resolve_moe_impl`` picks the recorded impl for the
   bench geometries.
4. **Spread**: repeated timed chains of the same step agree within
   ``TPU_DRA_MOE_SMOKE_SPREAD`` (default 50%; a wall-clock tripwire),
   flagged by this tool's copy of the reference's ``spread_flags``.

The parity gates hold the reference's 5e-4 on the largest absolute
difference for f32 parameters; for bf16 parameters (the kernels' type on
the card) they hold the largest absolute difference to
``BF16_PARITY_REL`` of the largest absolute reference value.

``run(params, config, device)`` returns the decisions (the impls' and
the dispatches' logits and their differences, the losses, the trace
keys, the auto picks) and the gates,
each a deterministic gate or a wall-clock tripwire; ``main()`` prints as
the reference does. The tool runs on the card unless ``--device cpu`` is
given; without a card it raises.

Exit 0 = all gates pass; 1 = a gate failed. Run from the repo root:
``python tools/run_moe_smoke_torch.py [--device cpu]``.
"""

import argparse
import dataclasses
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from _gate_torch import Gates, gate_device, moe_preset  # noqa: E402

SPREAD_LIMIT = float(os.environ.get("TPU_DRA_MOE_SMOKE_SPREAD", "0.5"))
SEED = int(os.environ.get("TPU_DRA_MOE_SMOKE_SEED", "1234"))
F32_PARITY_ABS = 5e-4
BF16_PARITY_REL = 2e-2
CHAINS, CHAIN_STEPS = 3, 5
AUTO_CASES = (
    ("8x160m", 8, 2048, "dropless"),     # small experts: fused path
    ("8x7b-L1", 4, 2048, "einsum"),      # big experts: einsum holds
    ("8x160m", 8, 1, "dropless"),        # decode batch
)


def spread_flags(metrics, rel: float = 0.02) -> list:
    """``_decodebench.spread_flags`` for the mixtral train metrics: flag
    any metric whose repeat spread exceeds ``rel`` of its mean."""
    flagged = []
    for m in metrics:
        if not m.get("metric", "").startswith("mixtral_"):
            continue
        if m.get("spread", 0.0) > rel * (m.get("value") or 1e-30):
            m["spread_flag"] = True
            flagged.append(m["metric"])
    return flagged


def seeded_tokens(vocab_size: int):
    import numpy as np

    rng = np.random.RandomState(SEED)
    return rng.randint(0, vocab_size, size=(2, 65)).astype(np.int64)


def ample(base):
    """``base`` at drop-free capacity, where the impls compute the same
    function."""
    return dataclasses.replace(base, capacity_factor=8.0, router_group=0)


def _sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def run(params, base, device, emit=print, name: str = "tiny-moe") -> dict:
    """Every gate of the smoke on ``params`` (of ``base``, a MoeConfig, on
    ``device``). Returns the gates and the decisions, with each parity
    gate's held number beside the largest absolute difference
    (``parity_held``, ``fused_vs_primitive_held``)."""
    import torch

    from k8s_dra_driver_tpu_torch.models import moe
    from k8s_dra_driver_tpu_torch.models.train import leaves
    from k8s_dra_driver_tpu_torch.ops import moe_dispatch

    gate = Gates()
    dev = torch.device(device)
    tokens = torch.as_tensor(seeded_tokens(base.vocab_size), device=dev)
    f32 = base.dtype == torch.float32
    out = {"gates": gate, "losses": {}, "trace_keys": {}}
    weights = leaves(params)
    for w in weights:
        w.requires_grad_(True)

    def parity(got, want) -> tuple:
        """(the number the gate holds, its limit, the largest absolute
        difference)."""
        err = float((got - want).abs().max())
        if f32:
            return err, F32_PARITY_ABS, err
        return err / max(float(want.abs().max()), 1e-30), BF16_PARITY_REL, err

    # Gate 1+4: compile-once and spread, per impl.
    metrics = []
    for impl in ("einsum", "binned", "dropless"):
        cfg = dataclasses.replace(base, moe_impl=impl)

        def step(cfg=cfg):
            loss = moe.loss_fn(params, tokens, cfg, remat=True)
            grads = torch.autograd.grad(loss, weights)
            return loss.detach(), grads

        loss, _ = step()
        float(loss)
        before = dict(moe.MOE_TRACE_COUNTS)
        # Time CHAINS of steps, not single dispatches: this gate hunts for
        # re-builds (10x+), not microseconds.
        times = []
        for _ in range(CHAINS):
            t0 = time.perf_counter()
            for _ in range(CHAIN_STEPS):
                loss, _ = step()
            float(loss)
            times.append(time.perf_counter() - t0)
        after = dict(moe.MOE_TRACE_COUNTS)
        out["trace_keys"][impl] = sorted(after)
        out["losses"][impl] = float(loss)
        gate(after == before,
             f"{impl}: retraced on identical shapes ({before} -> {after})")
        mean = sum(times) / len(times)
        spread = (max(times) - min(times)) / 2
        metrics.append({
            "metric": f"mixtral_{name}-{impl}_train_step",
            "value": mean,
            "spread": spread,
        })
        emit(f"moebench {impl}: {CHAIN_STEPS}-step chain "
             f"{mean * 1e3:.1f} ms spread {spread / mean:.1%} loss "
             f"{float(loss):.4f}")

    flagged = spread_flags(metrics, rel=SPREAD_LIMIT)
    for m in metrics:
        ok = m["metric"] not in flagged
        gate(ok, f"{m['metric']}: repeat spread "
                 f"{'within' if ok else 'exceeds'} {SPREAD_LIMIT:.0%} of "
                 f"the mean", kind="wall")

    # Gate 2: impl parity at drop-free capacity...
    outs = {}
    with torch.no_grad():
        for impl in ("einsum", "binned", "dropless"):
            cfg = dataclasses.replace(ample(base), moe_impl=impl)
            logits, _aux = moe.forward(params, tokens[:, :-1], cfg)
            outs[impl] = logits.float()
            # The forward's second run on identical shapes adds no key.
            before = dict(moe.MOE_TRACE_COUNTS)
            moe.forward(params, tokens[:, :-1], cfg)
            after = dict(moe.MOE_TRACE_COUNTS)
            gate(after == before, f"{impl} forward: retraced on identical "
                                  f"shapes ({before} -> {after})")
        errs, out["parity_held"] = {}, {}
        for impl in ("binned", "dropless"):
            held, limit, err = parity(outs[impl], outs["einsum"])
            errs[impl] = err
            out["parity_held"][impl] = held
            gate(held <= limit,
                 f"{impl} diverges from einsum at ample capacity: {err}")
        out["parity"] = errs
        out["outputs"] = outs
        emit(f"moebench parity: binned/dropless match einsum "
             f"(max {max(errs.values()):.2e})")

        # ...and fused dispatch kernels vs the primitive path.
        cfg_d = dataclasses.replace(ample(base), moe_impl="dropless")
        dispatched = {}
        for impl in ("primitive", "fused"):
            moe_dispatch.set_dispatch_impl(impl)
            try:
                logits, _ = moe.forward(params, tokens[:, :-1], cfg_d)
            finally:
                moe_dispatch.set_dispatch_impl("auto")
            _sync(dev)
            dispatched[impl] = logits.float()
        held, limit, err = parity(dispatched["fused"],
                                  dispatched["primitive"])
        out["fused_vs_primitive"] = err
        out["fused_vs_primitive_held"] = held
        out["dispatched"] = dispatched
        gate(held <= limit, f"fused dispatch diverges from primitive: {err}")
        emit(f"moebench fused-vs-primitive: max {err:.2e}")

    # Gate 3: the auto policy picks the recorded winners.
    out["auto"] = []
    auto_ok = True
    for preset, batch, seq, want in AUTO_CASES:
        got = moe.resolve_moe_impl(moe.MOE_PRESETS[preset], batch * seq)
        out["auto"].append(got)
        auto_ok &= got == want
        gate(got == want, f"auto({preset}, t={batch * seq}) = {got}, "
                          f"want {want}")
    emit("moebench auto policy: ok" if auto_ok
         else "moebench auto policy: FAIL")
    for w in weights:
        w.requires_grad_(False)
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--device", default=None,
                        help="where the model runs (default cuda)")
    args = parser.parse_args(argv)
    from k8s_dra_driver_tpu_torch.models import moe

    dev = gate_device(args.device)
    name = moe_preset(dev)
    base = moe.MOE_PRESETS[name]
    out = run(moe.init_params(base, seed=SEED, device=dev), base, dev,
              name=name)
    failures = out["gates"].failures()
    if failures:
        for f in failures:
            print(f"FAIL: {f}", file=sys.stderr)
        return 1
    print("moebench: compile-once, impl parity, fused-kernel parity, "
          "auto policy, spread within limit")
    return 0


if __name__ == "__main__":
    sys.exit(main())
