#!/usr/bin/env python3
"""Elastic-training smoke on the PyTorch port: chip-unplug -> gang
resize -> live reshard -> resume, with a fixed seed.

Twin of ``tools/run_elastic_smoke.py`` (``make elastic``) over
``k8s_dra_driver_tpu_torch``: the same steps, seed, gates, printed
lines and exit codes. It imports nothing of JAX.

1. a 4-chip FakeChipLib node publishes slices through the port's Driver;
2. a gang claim is allocated by the ReferenceAllocator and prepared
   over the DRA RPC surface;
3. an ElasticTrainer runs the ``tiny`` llama on the gang's members;
4. the seeded chaos plan unplugs a chip at the top of train step 4;
5. the driver's elastic coordinator shrinks the claim (checkpointed
   resize protocol), the trainer live-reshards and keeps stepping;
6. the chip is restored, the gang grows back, the trainer reshards up;
7. PASS requires: both resizes took the LIVE path (no checkpoint
   restore), the loss trajectory matches an uninterrupted run on the
   surviving topology within tolerance, the StateAuditor reports zero
   drift after each resize, and the GangResized Events landed.

The Driver's device-watch thread notices each health transition, as
the reference's does, and republishes; the port's Driver lands that
republish before its elastic re-solve reads the slice (the reference's
re-solve can read the slice as it was and find 3 of 4 devices).

The gang is keyed by members (the claim's device names), every one of
whose devices is ``--device`` (default ``cuda``: one card holds the whole
gang; ``cpu`` in tests), as ``parallel/elastic.py`` sets out. Without a
card and without ``--device cpu`` the tool raises; it never falls back.

``run(device, init=None, tokens=None)`` returns the decisions (the
resize messages and the trainer's resize events, the member lists, the
losses of both runs) and the first failed gate; ``init`` (a float
parameter tree as numpy) and ``tokens`` (seven [8, 65] batches) let a
test start both trainers from another package's initial parameters and
batches. ``main()`` prints as the reference does.

Exit 0 on PASS, 1 on any violated gate. TPU_DRA_CHAOS_SEED overrides
the seed (default 1234) -- the same seed replays the same schedule.
Run from the repo root: ``python tools/run_elastic_smoke_torch.py
[--device cpu]``.
"""

import argparse
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from _gate_torch import gate_device, model_config  # noqa: E402

SEED = int(os.environ.get("TPU_DRA_CHAOS_SEED", "1234"))
MEMBERS = ("tpu-0", "tpu-1", "tpu-2", "tpu-3")
STEPS = 7
BATCH = 8
LOSS_TOL = 2e-4     # the reference's rtol and atol on the loss continuity
# bf16 weights (the card's) hold the losses to phase 39's relative limit.
BF16_LOSS_REL = 1e-2


class GateFailed(Exception):
    """A violated gate; its message is the reference's FAIL line."""


def wait_for(pred, timeout=20.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.02)
    return False


def seeded_tokens(vocab_size: int, seed: int = SEED) -> list:
    """``STEPS`` batches of [8, 65] tokens from numpy's seeded generator
    (the reference draws its batches with JAX's)."""
    import numpy as np

    rng = np.random.RandomState(seed)
    return [rng.randint(0, vocab_size, size=(BATCH, 65)) for _ in range(STEPS)]


def run(device, init=None, tokens=None, seed: int = SEED, emit=print,
        config=None) -> dict:
    """The smoke's decisions, with ``failure`` the first violated gate's
    message (None on PASS). ``emit`` takes the progress lines; ``config``
    defaults to the ``tiny`` preset."""
    out = {"seed": seed, "failure": None}
    try:
        _run(device, init, tokens, seed, emit, out, config)
    except GateFailed as e:
        out["failure"] = str(e)
    return out


def _event(ev) -> dict:
    return {k: getattr(ev, k) for k in ("direction", "path", "n_old",
                                        "n_used", "n_idled", "old_mesh",
                                        "new_mesh")}


def _run(device, init, tokens, seed, emit, out, cfg):
    import random

    import numpy as np
    import torch

    from k8s_dra_driver_tpu_torch import resolve_device
    from k8s_dra_driver_tpu_torch.kube import (
        EVENTS,
        NODES,
        RESOURCE_CLAIMS,
        RESOURCE_SLICES,
        FakeKubeClient,
    )
    from k8s_dra_driver_tpu_torch.kube.allocator import ReferenceAllocator
    from k8s_dra_driver_tpu_torch.kube.protos import dra_v1alpha4 as drapb
    from k8s_dra_driver_tpu_torch.models import params_from_numpy
    from k8s_dra_driver_tpu_torch.models.llama import PRESETS
    from k8s_dra_driver_tpu_torch.models.train import (
        make_optimizer,
        train_state_from_params,
    )
    from k8s_dra_driver_tpu_torch.parallel import MeshConfig
    from k8s_dra_driver_tpu_torch.parallel.elastic import ElasticTrainer
    from k8s_dra_driver_tpu_torch.plugin.driver import Driver, DriverConfig
    from k8s_dra_driver_tpu_torch.tpulib import FakeChipLib
    from k8s_dra_driver_tpu_torch.utils import faults
    from k8s_dra_driver_tpu_torch.utils.metrics import Registry

    dev = resolve_device(device)
    # A short root: the Driver's sockets stay under AF_UNIX's limit.
    tmp = tempfile.mkdtemp(prefix="elastic-smoke-")
    client = FakeKubeClient()
    client.create(NODES, {"metadata": {"name": "node-a", "uid": "nu-1"}})
    lib = FakeChipLib(generation="v5p", topology="4x1x1")
    driver = Driver(DriverConfig(
        node_name="node-a", chiplib=lib, kube_client=client,
        cdi_root=f"{tmp}/cdi", plugin_root=f"{tmp}/plugin",
        registrar_root=f"{tmp}/registry", state_root=f"{tmp}/state",
        node_uid="nu-1", cleanup_interval_seconds=0,
        device_watch_interval_seconds=0.05,
    ))
    allocator = ReferenceAllocator(client, registry=Registry())
    driver.enable_elastic(allocator)
    resizes = []
    driver.add_resize_listener(resizes.append)
    driver.start()
    try:
        if not wait_for(lambda: len(client.list(RESOURCE_SLICES)) >= 1):
            raise GateFailed("slices never published")
        claim = {
            "apiVersion": "resource.k8s.io/v1beta1",
            "kind": "ResourceClaim",
            "metadata": {"name": "train", "namespace": "default",
                         "uid": "uid-gang"},
            "spec": {"devices": {"requests": [{
                "name": "gang", "deviceClassName": "tpu.google.com",
                "allocationMode": "ExactCount", "count": 4}]}},
        }
        allocator.allocate(claim, node_name="node-a")
        client.create(RESOURCE_CLAIMS, claim, namespace="default")
        resp = driver.NodePrepareResources(
            drapb.NodePrepareResourcesRequest(claims=[drapb.Claim(
                uid="uid-gang", name="train", namespace="default")]),
            None,
        )
        if resp.claims["uid-gang"].error:
            raise GateFailed(f"prepare: {resp.claims['uid-gang'].error}")

        if cfg is None:
            cfg = PRESETS["tiny"]
        device_of = dict.fromkeys(MEMBERS, dev)

        def trainer_on(members, axes):
            trainer = ElasticTrainer(
                cfg, make_optimizer(warmup_steps=1, total_steps=10),
                list(members), mesh_config=MeshConfig(**axes),
                global_batch=BATCH, device_of=device_of)
            if init is not None:
                trainer.state = train_state_from_params(
                    params_from_numpy(init, cfg, device=dev),
                    trainer.optimizer, mesh=trainer.mesh)
            return trainer

        trainer = trainer_on(MEMBERS, dict(data=2, tensor=2))
        # The uninterrupted run on the surviving topology (tensor 2 over
        # two members), from the same initial parameters: ElasticTrainer
        # draws them from its seed, or both convert ``init``.
        reference = trainer_on(MEMBERS[:2], dict(tensor=2))
        toks = [torch.as_tensor(np.asarray(t), device=dev) for t in (
            tokens if tokens is not None
            else seeded_tokens(cfg.vocab_size, seed))]
        ref_losses = [reference.step(t) for t in toks]
        out["reference_losses"] = ref_losses
        del reference

        victim = random.Random(seed).randrange(4)
        out["victim"] = f"tpu-{victim}"
        plan = faults.FaultPlan()
        plan.call("train.step",
                  lambda: lib.unplug_chip(victim, reason="smoke unplug"),
                  on_calls={4})
        losses = []
        out["losses"] = losses
        with faults.armed(plan):
            for t in toks[:4]:
                losses.append(trainer.step(t))
        if not wait_for(lambda: len(resizes) >= 1):
            raise GateFailed("no shrink resize message")
        msg = resizes[0]
        out["shrink"] = dict(devices=list(msg.devices),
                             removed=list(msg.removed), reason=msg.reason)
        emit(f"shrink: {msg.devices} (removed {msg.removed}) — "
             f"{msg.reason}")
        event = trainer.resize(list(msg.devices), reason=msg.reason)
        out["shrink_event"] = _event(event)
        out["members_after_shrink"] = list(trainer.members)
        if event.path != "live":
            raise GateFailed(f"shrink took the {event.path} path, not live")
        for t in toks[4:]:
            losses.append(trainer.step(t))
        try:
            if cfg.dtype == torch.float32:
                np.testing.assert_allclose(losses, ref_losses, rtol=LOSS_TOL,
                                           atol=LOSS_TOL)
            else:
                np.testing.assert_allclose(losses, ref_losses,
                                           rtol=BF16_LOSS_REL)
        except AssertionError as e:
            raise GateFailed(f"loss continuity: {e}")
        if not wait_for(lambda: driver.auditor.run_once() == []):
            raise GateFailed(
                f"auditor drift after shrink: {driver.auditor.findings}")

        lib.restore_chip(victim)
        if not wait_for(lambda: len(resizes) >= 2):
            raise GateFailed("no grow resize message")
        grow = resizes[1]
        out["grow"] = dict(devices=list(grow.devices),
                           added=list(grow.added), reason=grow.reason)
        emit(f"grow: {grow.devices} (added {grow.added}) — {grow.reason}")
        event = trainer.resize(list(grow.devices), reason=grow.reason)
        out["grow_event"] = _event(event)
        out["members_after_grow"] = list(trainer.members)
        if event.path != "live" or event.n_used != 4:
            raise GateFailed(f"grow: path={event.path} used={event.n_used}")
        post = [trainer.step(t) for t in toks[:2]]
        out["post_grow_losses"] = post
        if not all(np.isfinite(x) for x in post):
            raise GateFailed(f"non-finite loss after grow: {post}")
        if not wait_for(lambda: driver.auditor.run_once() == []):
            raise GateFailed(
                f"auditor drift after grow: {driver.auditor.findings}")
        driver.events.flush()
        reasons = [e["reason"] for e in client.list(EVENTS)]
        if "GangResized" not in reasons:
            raise GateFailed(
                f"no GangResized Event (saw {sorted(set(reasons))})")
        shrinks = driver._m_elastic_resizes.value(direction="shrink",
                                                  outcome="ok")
        grows = driver._m_elastic_resizes.value(direction="grow",
                                                outcome="ok")
        out["resize_metrics"] = (shrinks, grows)
        if (shrinks, grows) != (1.0, 1.0):
            raise GateFailed(f"resize metrics: shrink={shrinks} "
                             f"grow={grows}")
        out["trace"] = [(r["direction"], len(r["devices"]))
                        for r in driver.resize_trace()]
    finally:
        driver.shutdown()


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--device", default=None,
                        help="the gang's device (default cuda)")
    args = parser.parse_args(argv)
    dev = gate_device(args.device)
    out = run(dev, config=model_config(dev))
    if out["failure"] is not None:
        print(f"FAIL: {out['failure']}")
        return 1
    print(f"PASS: seed={out['seed']} victim={out['victim']} "
          f"losses[{len(out['losses'])}] match uninterrupted run; "
          f"trace={out['trace']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
