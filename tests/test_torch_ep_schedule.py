"""The expert-parallel schedule and its plumbing, on four gloo ranks of
a (2, 2) mesh (reduced moe-gpt3-s, fp32; ZeRO-3 expert shards):

* the overlapped schedule (``pipeline_unroll=True``) issues chunk i+1's
  dispatch All-to-All before chunk i's expert FFN, the serial one after
  it, and the two give bit-equal losses, gradients and logits under
  NONE, S4 and S1 (n = 2 for the gradients: two chunks' contributions
  to a weight add in either order to the same float; n = 4 for the
  forward's order and logits);
* S1 (``T_DI`` from the stash, its cotangent sent back through the
  reverse All-to-All) and S4 (the All-to-All re-run) give NONE's
  gradients within rtol 1e-4;
* the rank layout (rank = dp_rank · ep + ep_rank, the EP and dp
  groups) is the JAX mesh's device layout, and ``ep_split`` is JAX's;
* every rank resolves the same ``(n, strategy)`` when their
  ``measure_fn`` timings differ (each alone would pick another n);
* the backward pass under the overlapped schedule (n = 4) has, for NONE,
  S4 and S1, an All-to-All in flight across each of at least three
  other chunks' expert FFNs (their recompute or their backward) between
  its issue and its wait, in every MoE layer; the serial schedule waits
  on each at once;
* the train launcher finishes under ``torch.distributed.run
  --nproc-per-node 2 ... --device cpu``, and run again over its
  ``--ckpt-dir`` resumes from the step it saved.
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

from repro.distributed.context import ep_split as jax_ep_split
from repro_torch.configs import get_config
from repro_torch.distributed import ep_split
from torch_ep_harness import (SRC_PATH, _free_port, finish_jax_reference,
                              run_ranks, schedule_rank, spans,
                              start_jax_reference)

MESH = (2, 2)
STRATEGIES = ("none", "s4", "s1")
CANDIDATES = (1, 2, 4, 8)


def _timings():
    """Rank r's seconds for candidate n: fastest at n = 2^r alone."""
    return [{n: 1.0 + 0.25 * abs(int(np.log2(n)) - r) for n in CANDIDATES}
            for r in range(MESH[0] * MESH[1])]


_JAX_LAYOUT = r"""
import sys
import numpy as np
from repro.compat import make_mesh
mesh = make_mesh((2, 2), ("data", "model"))
np.savez(sys.argv[1] + "/out.npz",
         ids=np.vectorize(lambda d: d.id)(mesh.devices))
"""

_RESULTS = {}


def _run(tmp_path_factory):
    if _RESULTS:
        return _RESULTS
    base = get_config("moe-gpt3-s").reduced()
    cfgs = {s: dataclasses.replace(base, moe=dataclasses.replace(
        base.moe, num_partitions=2, memory_reuse_strategy=s))
        for s in STRATEGIES}
    rng = np.random.default_rng(4)
    tokens = rng.integers(0, base.vocab_size, (4, 32), dtype=np.int32)
    labels = rng.integers(0, base.vocab_size, (4, 32), dtype=np.int32)
    tmp = tmp_path_factory.mktemp("ep_layout")
    proc = start_jax_reference(_JAX_LAYOUT, tmp, {}, devices=4)
    _RESULTS["ranks"] = run_ranks(schedule_rank, MESH, cfgs, tokens, labels,
                                  _timings())
    _RESULTS["jax_ids"] = finish_jax_reference(proc, tmp)["ids"]
    return _RESULTS


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_overlapped_and_serial_schedules_bit_equal(strategy,
                                                   tmp_path_factory):
    for r in _run(tmp_path_factory)["ranks"]:
        a, b = r[(strategy, True)], r[(strategy, False)]
        assert a["loss"] == b["loss"]
        for x, y in zip(a["grads"], b["grads"]):
            np.testing.assert_array_equal(x, y)
        np.testing.assert_array_equal(a["logits"], b["logits"])


def test_overlap_issues_next_dispatch_before_expert_ffn(tmp_path_factory):
    for r in _run(tmp_path_factory)["ranks"]:
        for unroll in (True, False):
            log = r[("none", unroll)]["events"]
            # 4 chunks an MoE layer, 2 MoE layers
            assert log.count("F") == 8 and log.count("D") == 8
            per_layer = len(log) // 2
            for layer in (log[:per_layer], log[per_layer:]):
                d = [i for i, e in enumerate(layer) if e == "D"]
                f = [i for i, e in enumerate(layer) if e == "F"]
                for i in range(3):
                    assert (d[i + 1] < f[i]) == unroll, (unroll, layer)


@pytest.mark.parametrize("strategy", ["s4", "s1"])
def test_recompute_strategies_match_none(strategy, tmp_path_factory):
    for r in _run(tmp_path_factory)["ranks"]:
        np.testing.assert_allclose(r[(strategy, True)]["loss"],
                                   r[("none", True)]["loss"], rtol=1e-6)
        for x, y in zip(r[(strategy, True)]["whole"],
                        r[("none", True)]["whole"]):
            np.testing.assert_allclose(x, y, rtol=1e-4, atol=1e-6)


def test_rank_layout_is_jax_mesh_layout(tmp_path_factory):
    res = _run(tmp_path_factory)
    ids = res["jax_ids"]
    for r in res["ranks"]:
        lay = r["layout"]
        d, e = lay["dp_rank"], lay["ep_rank"]
        assert lay["rank"] == ids[d, e] == d * MESH[1] + e
        assert lay["ep_group"] == sorted(ids[d, :].tolist())
        assert lay["dp_group"] == sorted(ids[:, e].tolist())


def test_ep_split_matches_jax():
    for devices in range(1, 17):
        for experts in (0, 1, 4, 6, 60, 64):
            assert ep_split(devices, experts) == jax_ep_split(devices,
                                                              experts)


def test_every_rank_resolves_the_same_n_strategy(tmp_path_factory):
    timings = _timings()
    alone = {min(t, key=t.get) for t in timings}
    assert len(alone) == len(timings)             # each alone would differ
    slowest = {n: max(t[n] for t in timings) for n in CANDIDATES}
    resolved = {r["resolved"] for r in _run(tmp_path_factory)["ranks"]}
    assert len(resolved) == 1
    assert resolved.pop()[0] == min(slowest, key=slowest.get)


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_backward_all_to_alls_span_another_chunks_ffn(strategy,
                                                      tmp_path_factory):
    """Between an All-to-All's issue and its wait no FFN of its own chunk
    can run (each stage waits on its chunk's collective before it
    starts), so an FFN event there is another chunk's."""
    for r in _run(tmp_path_factory)["ranks"]:
        for unroll in (True, False):
            log = r[(strategy, unroll)]["backward"]
            ffn = "B" if strategy == "none" else "FB"
            assert {e[0] for e in log if e[0] in "FB"} == set(ffn)
            per_layer = len(spans(log)) // 2
            assert per_layer == (8 if strategy == "none" else
                                 16 if strategy == "s4" else 12)
            for layer in (spans(log)[:per_layer], spans(log)[per_layer:]):
                crossed = sum(1 for s in layer if s)
                if unroll:    # every chunk's FFN but one (n = 4)
                    assert crossed >= 3, layer
                else:
                    assert crossed == 0, layer


def test_train_launcher_over_two_ranks_on_cpu(tmp_path):
    """Steps 0-1 saved at 2, then a second run over the same directory to
    4 resumes at step 2."""
    env = dict(os.environ, PYTHONPATH=SRC_PATH + (
        os.pathsep + os.environ["PYTHONPATH"]
        if os.environ.get("PYTHONPATH") else ""), OMP_NUM_THREADS="1")
    for steps, first in ((2, 0), (4, 2)):
        out = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run",
             "--nproc-per-node", "2", "--master-port", str(_free_port()),
             "-m", "repro_torch.launch.train", "--mesh-model", "2",
             "--device", "cpu", "--steps", str(steps), "--batch", "4",
             "--seq", "16", "--ckpt-dir", str(tmp_path),
             "--ckpt-every", "2"],
            env=env, capture_output=True, text=True, timeout=120)
        assert out.returncode == 0, out.stderr[-3000:]
        assert "mesh: data=1 model=2 backend=gloo world=2" in out.stdout
        assert f"at step {steps - 1}" in out.stdout, out.stdout
        assert (f"restored checkpoint at step {first}" in out.stderr) == (
            first > 0)
    assert sorted(os.listdir(tmp_path)) == ["step_0000000002",
                                            "step_0000000004"]
