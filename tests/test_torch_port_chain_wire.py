"""The chain's compressed hop wires and the chaos wire, against JAX.

- ``int8``, ``topk8``, ``clapping`` and ``topk8`` under the adaptive
  density controller on every hop wire (``LocalTransport``'s emulated
  wire), M 2, lag 1, 4 steps on the synthetic MNIST batches the
  two-party tests train on: losses within the tolerance
  ``tests/test_torch_port_two_party.py`` holds each wire mode to (1e-3:
  a value near an int8 rounding boundary can land on the other side
  after float32 drift), every wire's round trips, frame bytes and
  compressed byte counts equal to JAX's, and the controller's
  decisions (a window every step) and densities equal to JAX's. topk8's kept set
  is discontinuous: where two magnitudes at the threshold differ by
  less than the frameworks' float32 drift, one run keeps the one and
  the other the other, and the error feedback carries the difference
  on. The chain packs 4S - 6 tensors a microbatch (12 a step here), so
  a free-running pair meets such a tie sooner than the two-party pair
  (2 a step): on these batches the topk8 chain matches JAX within
  1.7e-5 for 4 steps, and a flip at step 5 moves the loss 6.3e-3; on
  ``randn`` inputs, where the chain's loss climbs to 20, a flip moved
  step 8 by 1.4e-3.
- chaos (``drop_req``, ``drop_resp``, ``dup``) on every hop wire: the
  loss series of the clean chain bit for bit, each hop counted once per
  microbatch and one deferred update a step (no double apply).
"""

import numpy as np
import pytest

from split_learning_tpu.data.datasets import batches as jax_batches
from split_learning_tpu.data.datasets import synthetic as jax_synthetic
from split_learning_tpu.transport.density import (
    DensityController as JaxDensity)
from split_learning_tpu_torch.transport import (
    ChaosPolicy, ChaosTransport, DensityController)
from test_torch_port_chain import drive, jax_chain, port_chain
from test_torch_port_two_party import TOL

M, LAG, STEPS = 2, 1, 4
BATCH = 8


def _data():
    ds = jax_synthetic("mnist", n_train=BATCH * STEPS, n_test=8, seed=3)
    return list(jax_batches(ds.train, BATCH, seed=3))


@pytest.mark.parametrize("mode", ["int8", "topk8", "clapping", "auto"])
def test_compressed_hop_wires_match_jax(mode):
    compress = "topk8" if mode == "auto" else mode
    jdc = JaxDensity(window=1) if mode == "auto" else None
    dc = DensityController(window=1) if mode == "auto" else None
    jrunner, _, jwires = ref = jax_chain(M, LAG, compress=compress, dc=jdc)
    data = _data()
    want = drive(ref, STEPS, data=data)
    runner, stages, wires = chain = port_chain(M, LAG, compress=compress,
                                               dc=dc)
    got = drive(chain, STEPS, data=data)
    np.testing.assert_allclose(got, want, atol=TOL[compress], rtol=0)
    for ours, theirs in zip(wires, jwires):
        for field in ("round_trips", "bytes_sent", "bytes_received"):
            assert getattr(ours.stats, field) == getattr(
                theirs.stats, field), (mode, field)
        assert ours.stats.counters == theirs.stats.counters
        assert ours.stats.counters["compress_wire_bytes"] > 0
    if mode == "auto":
        ours, theirs = dc.snapshot(), jdc.snapshot()
        assert [(r["action"], r["wire"], r["densities"])
                for r in ours["trajectory"]] == [
            (r["action"], r["wire"], r["densities"])
            for r in theirs["trajectory"]]
        np.testing.assert_allclose(
            [r["mean_loss"] for r in ours["trajectory"]],
            [r["mean_loss"] for r in theirs["trajectory"]],
            atol=TOL[compress], rtol=0)
        assert dc.snapshot()["windows_closed"] == STEPS
        rows = runner.stage_report()
        assert [r["density"] for r in rows] == [
            dc.densities()[f"hop{i}"] for i in (1, 2)]
    for s in stages:   # the peers folded the same bytes into their gauges
        assert s.metrics()["gauges"]["wire_compression_ratio"] > 1.0


def test_chaos_on_every_hop_wire_never_double_applies():
    clean = drive(port_chain(M, LAG), STEPS)
    policy = ChaosPolicy("drop_req=0.15,drop_resp=0.2,dup=0.2", seed=5)
    runner, stages, wires = chain = port_chain(
        M, LAG, wrap=lambda t: ChaosTransport(t, policy))
    chaotic = drive(chain, STEPS)
    assert chaotic == clean
    assert sum(policy.injected.values()) > 0
    hits = 0
    for s in stages:
        ctr = s.counters()
        for op in (("hop_loss",) if s.is_last else ("hop_fwd", "hop_bwd")):
            assert ctr[op] == STEPS * M, (s.party, op, ctr)
        assert ctr["deferred_enqueued"] == ctr["deferred_applied"] == STEPS
        hits += ctr["replay_hits"]
    assert hits > 0   # the faults reached the replay cache
    for t in wires:
        assert sum(v for k, v in t.stats.counters.items()
                   if k.startswith("chaos_")) > 0
