"""``tools/run_elastic_smoke_torch.py`` against
``tools/run_elastic_smoke.py`` on the default seed, on the CPU at
``tiny``.

The reference tool runs as it is, its ``ElasticTrainer`` wrapped to
record the gang trainer's initial parameters, every step's batch and
loss, and every resize event, and its Driver's republish synced before
the watch thread re-solves the gang (below); the twin then starts both of its trainers
from those parameters and steps them on those batches. Decisions only:
the two resize messages (devices, removed/added, reason), both resize
events (live path, members used and idled, old and new mesh), the member
lists, the trace and the verdict; the losses within 1e-2 of the
reference's.
"""

import contextlib
import io

import numpy as np
import pytest

from test_torch_gate_common import load_tool, one_torch_thread

LOSS_REL = 1e-2
EVENT_KEYS = ("direction", "path", "n_old", "n_used", "n_idled",
              "old_mesh", "new_mesh")


def names(devices) -> list:
    """The reference's gang devices as the claim's device names (its
    tool maps ``tpu-<i>`` to ``jax.devices()[i]``)."""
    return [f"tpu-{d.id}" for d in devices]


@pytest.fixture(scope="module")
def runs():
    with one_torch_thread():
        import jax

        from k8s_dra_driver_tpu.parallel import elastic as jelastic
        from k8s_dra_driver_tpu.plugin import driver as jdriver

        inits, trainers, steps, events = [], [], [], []
        cls = jelastic.ElasticTrainer
        mp = pytest.MonkeyPatch()
        real_init, real_step, real_resize = cls.__init__, cls.step, cls.resize

        def init(self, *args, **kwargs):
            real_init(self, *args, **kwargs)
            trainers.append(self)
            inits.append(jax.tree.map(np.array, self.state.params))

        def step(self, tokens):
            loss = real_step(self, tokens)
            steps.append((trainers.index(self), np.array(tokens), loss))
            return loss

        def resize(self, *args, **kwargs):
            event = real_resize(self, *args, **kwargs)
            events.append(dict({k: getattr(event, k) for k in EVENT_KEYS},
                               members=names(self.devices),
                               idled=names(self.idled)))
            return event

        real_publish = jdriver.Driver.publish_resources

        def publish_resources(self):
            # The watch thread re-solves a resized gang right after it
            # republishes, and the reference's slice controller syncs on
            # a thread of its own: on a loaded host the grow's re-solve
            # can read the stale slice (3 of 4 devices) and the reference
            # tool fails. Syncing first keeps the order its comment
            # requires ("the re-solve reads published slices, which must
            # already reflect the transition").
            real_publish(self)
            self.plugin._slice_controller.sync_once()

        try:
            mp.setattr(jdriver.Driver, "publish_resources", publish_resources)
            mp.setattr(cls, "__init__", init)
            mp.setattr(cls, "step", step)
            mp.setattr(cls, "resize", resize)
            printed = io.StringIO()
            with contextlib.redirect_stdout(printed):
                try:
                    rc = load_tool("run_elastic_smoke").main() or 0
                except SystemExit as e:
                    rc = e.code
        finally:
            mp.undo()
        # Trainer 0 is the gang's, trainer 1 the uninterrupted run, which the
        # reference starts from trainer 0's initial parameters.
        gang = [(t, loss) for who, t, loss in steps if who == 0]
        uninterrupted = [(t, loss) for who, t, loss in steps if who == 1]
        lines = [ln for ln in printed.getvalue().splitlines()
                 if ln.startswith(("shrink:", "grow:", "PASS:", "FAIL:"))]
        return dict(rc=rc, lines=lines, init=inits[0], gang=gang,
                    uninterrupted=uninterrupted, events=events)


@pytest.fixture(scope="module")
def twin(runs):
    lines = []
    tokens = [t for t, _ in runs["uninterrupted"]]
    out = load_tool("run_elastic_smoke_torch").run(
        "cpu", init=runs["init"], tokens=tokens, emit=lines.append)
    return out, lines


def test_resize_messages_equal_the_reference(runs, twin):
    out, lines = twin
    assert runs["rc"] == 0 and out["failure"] is None
    assert lines == runs["lines"][:2]
    assert out["trace"] == [("shrink", 3), ("grow", 4)]


def test_resize_events_and_members_equal_the_reference(runs, twin):
    out, _ = twin
    got = [dict(out[f"{d}_event"], members=out[f"members_after_{d}"])
           for d in ("shrink", "grow")]
    want = [{k: v for k, v in e.items() if k != "idled"}
            for e in runs["events"]]
    assert got == want
    assert [e["path"] for e in got] == ["live", "live"]


def test_losses_within_1e2_of_the_reference(runs, twin):
    out, _ = twin
    want_gang = [float(loss) for _, loss in runs["gang"]]
    want_ref = [float(loss) for _, loss in runs["uninterrupted"]]
    got_gang = out["losses"] + out["post_grow_losses"]
    np.testing.assert_allclose(got_gang, want_gang, rtol=LOSS_REL)
    np.testing.assert_allclose(out["reference_losses"], want_ref,
                               rtol=LOSS_REL)
