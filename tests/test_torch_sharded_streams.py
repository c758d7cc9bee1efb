"""Mesh-aware streams of the port on 4 gloo ranks (the CPU runs the
kernels' plain versions), as the reference's tests/test_sharded_streams.py:

* every registry kernel that declares ``shard_dims`` run sharded over a
  4-way "data" mesh equals the unsharded call and its plain version;
* a kernel under ``shard_streams`` plans at the *local* shard shapes, its
  plan keyed by the mesh topology, and a repeat call hits the cache;
* the collectives with a ``policy`` route their per-hop product through
  ``repro_torch.ops.matmul`` (planned at local shapes under the mesh);
* ``pipeline_apply`` with a policy keeps GPipe parity.

One spawn of 4 ranks, joined with a 120 s limit.
"""

import numpy as np
import pytest
import torch

import _torch_dist_ranks as ranks
from repro_torch.kernels.registry import all_kernels
from repro_torch.launch.mesh import spawn_ranks


@pytest.fixture(scope="module")
def coll_in():
    rng = np.random.default_rng(3)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return {"x": f(64, 32), "w": f(32, 16), "x2": f(64, 128),
            "w2": f(128, 16), "ws": f(4, 16, 16) / 4.0, "mb": f(8, 4, 16)}


@pytest.fixture(scope="module")
def run(coll_in, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("streams4")
    return spawn_ranks(ranks.sharded_streams, 4, (coll_in,),
                       init_file=str(tmp / "rdv"), timeout=120)[0]


@pytest.mark.parametrize("name", [s.name for s in all_kernels()
                                  if s.shard_dims is not None])
def test_registry_kernel_sharded_equals_unsharded(run, name):
    err_un, err_ref, tol, _ = run["smoke"][name]
    # the reference's bound (tests/test_sharded_streams.py): the CPU's
    # products may block a shard's rows otherwise than the whole call's
    assert err_un <= max(tol, 1e-6), (name, "vs unsharded", err_un)
    assert err_ref <= max(tol, 1e-6), (name, "vs plain", err_ref)


def test_every_registry_kernel_declares_shard_dims():
    assert {s.name for s in all_kernels() if s.shard_dims is not None} == \
        {"ff_matmul", "ff_attention", "ff_decode_attention",
         "ff_chunk_scan", "ff_gather"}


def test_shard_streams_plans_local_workload_with_mesh_key(run):
    p = run["plan"]
    assert p["err"] < 1e-3
    assert p["local"] and p["words"] < p["global_words"]
    assert p["mesh"] == "data4" and p["devices"] == 4
    assert p["new_misses"] == 0 and p["hits"] >= 1


def test_collectives_policy_routes_ops_matmul(run, coll_in):
    c = run["collectives"]
    x, w, x2, w2 = (coll_in[k] for k in ("x", "w", "x2", "w2"))
    np.testing.assert_allclose(c["allgather_matmul"], x @ w, rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(c["matmul_reducescatter"], x2 @ w2,
                               rtol=1e-4, atol=1e-4)
    # each hop's product was planned by ops.matmul at the local shape,
    # under the mesh the collectives ran on
    assert c["plans"] == [("d4", True), ("d4", True)]


def test_pipeline_apply_with_policy_matches_sequential(run, coll_in):
    h = torch.from_numpy(coll_in["mb"])
    for s in range(4):
        h = torch.tanh(h @ torch.from_numpy(coll_in["ws"][s]))
    np.testing.assert_allclose(run["pipeline"]["last"], h.numpy(),
                               rtol=1e-5, atol=1e-6)
    assert run["pipeline"]["mesh"] == "pod4"
