"""``launch/serve.py`` on the host mesh: ``serve_bench`` on 4 gloo ranks
(spawned processes on the CPU, the process group joined as ``torchrun``
would) as (data 2, model 2), against the reference's schedulers and the
port's one-rank run.

Smoke qwen1.5-0.5B in f32 on ``test_torch_serve.py``'s trace (rate 0, 3
requests, 2 slots, page 8), drawn from seed 0 by ``serve_bench`` on every
rank; the reference's ``run_lockstep`` / ``run_continuous`` get the same
parameters, outside ``use_sharding`` (jax 0.9's Explicit-axis meshes
refuse ``constrain``) with ``PipePolicy(mode="ff", interpret=True)``:

* under ``--impl ff`` (the kernels' plain versions) and ``--impl xla``,
  with and without an EOS (the first token the port emits for request
  0): token counts and decode steps equal the reference's, the greedy
  tokens by rid the one-rank port's, the parity probe 0.0, the result's
  mesh (data 2, model 2) and every rank's tokens the same;
* ``--rate 10`` with each rank's clock running at ``1 + rank`` times real
  speed: every rank makes the same admissions in the same decode steps
  and emits the same tokens (the scheduler clock is the most over the
  ranks);
* ``--layer-graph`` and smoke grok-1 under ``--impl xla``: the one-rank
  tokens;
* a one-rank result reports the (1, 1) mesh and leaves no process group;
* ``python -m torch.distributed.run --nproc-per-node 2 -m
  repro_torch.launch.serve ...``: rank 0 alone prints and writes the
  JSON;
* ``--dist-backend``'s default: NCCL with a card a rank, ``gloo_staged``
  for ranks sharing a card, gloo on the CPU.

One spawn of ranks, joined with a 120 s limit; the reference runs in this
process meanwhile.
"""

import argparse
import concurrent.futures
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import _torch_dist_ranks as ranks
from repro.configs.base import smoke_config as j_smoke
from repro.core.program import PipePolicy
from repro.launch import serve as j_serve
from repro.models import build_model as j_build
from repro_torch.launch import serve as t_serve
from repro_torch.launch.mesh import spawn_ranks
from repro_torch.models import build_model as t_build
from repro_torch.models import layers as L

ROOT = Path(__file__).resolve().parents[1]
ARCH = "qwen1_5_0p5b"
PAGE, SLOTS, N_REQ, PROMPT, MAX_NEW = 8, 2, 3, 12, 4
BASE = ["--smoke", "--device", "cpu", "--rate", "0", "--requests",
        str(N_REQ), "--slots", str(SLOTS), "--page", str(PAGE),
        "--prompt-len", str(PROMPT), "--max-new", str(MAX_NEW)]
POLICY = PipePolicy(mode="ff", interpret=True)
KEYS = ("tokens", "decode_steps")
IMPLS = ("ff", "xla")
EOS_IDS = ("budget", "eos")
SKEWED = "skewed_clock"


def _args(argv):
    ap = argparse.ArgumentParser()
    t_serve.add_serve_args(ap)
    return ap.parse_args(argv)


def _argv(impl, eos):
    return BASE + ["--impl", impl] + ([] if eos is None
                                      else ["--eos-id", str(eos)])


def _reference(impl, eos):
    """The reference's two schedulers on the parameters ``serve_bench``
    draws (seed 0 of the port's generator), carried over leaf by leaf."""
    t_cfg = t_serve.smoke_config(ARCH)
    params = t_build(t_cfg).init_cast(torch.Generator().manual_seed(0),
                                      "cpu")
    jparams = L.tree_map(lambda t: jnp.asarray(t.numpy()), params)
    jcfg = j_smoke(ARCH).replace(attn_impl=impl, remat="none")
    if impl == "ff":
        jcfg = jcfg.replace(decode_block_kv=PAGE)
    jmodel = j_build(jcfg)
    reqs = j_serve.make_requests(N_REQ, prompt_len=PROMPT, max_new=MAX_NEW,
                                 rate=0.0, vocab=jcfg.vocab, seed=0)
    kw = dict(n_slots=SLOTS, page=PAGE, eos_id=eos, policy=POLICY)
    return (j_serve.run_lockstep(jmodel, jparams, jcfg, reqs, **kw),
            j_serve.run_continuous(jmodel, jparams, jcfg, reqs, **kw))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The one-rank port's results, the mesh's (every rank's) and the
    reference's, by case."""
    one = {("ff", None): t_serve.serve_bench(_args(_argv("ff", None)))}
    eos = one[("ff", None)]["paged"]["outputs"][0][0]
    cases = {f"{impl}-{e}": _argv(impl, eos if e == "eos" else None)
             for impl in IMPLS for e in EOS_IDS}
    cases[SKEWED] = BASE[:3] + ["--rate", "10"] + BASE[5:] + ["--impl",
                                                             "xla"]
    cases["layer_graph"] = BASE + ["--layer-graph"]
    cases["grok"] = BASE + ["--arch", "grok1_314b", "--impl", "xla"]
    tmp = tmp_path_factory.mktemp("serve_mesh")
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        mesh = pool.submit(spawn_ranks, ranks.serve_mesh_cases, 4,
                           (list(cases.items()), (SKEWED,)),
                           init_file=str(tmp / "rdv"), timeout=120)
        ref = {(impl, e): _reference(impl, eos if e == "eos" else None)
               for impl in IMPLS for e in EOS_IDS}
        one.update({name: t_serve.serve_bench(_args(argv))
                    for name, argv in cases.items() if name != SKEWED})
        mesh = mesh.result()
    return dict(one=one, mesh=mesh, ref=ref, eos=eos)


@pytest.mark.parametrize("eos", EOS_IDS)
@pytest.mark.parametrize("impl", IMPLS)
def test_mesh_serve_matches_reference_and_one_rank(runs, impl, eos):
    name = f"{impl}-{eos}"
    got = runs["mesh"][0][name]
    one = runs["one"][name]
    ref_lock, ref_cont = runs["ref"][(impl, eos)]
    assert got["mesh"] == {"data": 2, "model": 2}
    assert {k: got["lockstep"][k] for k in KEYS} == \
        {k: ref_lock[k] for k in KEYS}
    assert {k: got["paged"][k] for k in KEYS} == \
        {k: ref_cont[k] for k in KEYS}
    for kind in ("lockstep", "paged"):
        assert got[kind]["outputs"] == one[kind]["outputs"], kind
    assert got["bitwise_max_abs_diff"] == 0.0
    assert got["bitwise_identical"] and got["token_count_parity"]
    assert got["ranks_agree"]
    assert got["compiled_graphs"] == {}
    for other in runs["mesh"][1:]:
        assert other[name]["paged"]["outputs"] == got["paged"]["outputs"]
    if eos == "eos":             # the EOS bites: request 0 stops at once
        assert got["paged"]["tokens"] < \
            runs["mesh"][0][f"{impl}-budget"]["paged"]["tokens"]


def test_skewed_clocks_make_the_same_admissions(runs):
    """Each rank's clock runs at 1 + rank times real speed; the trace
    clock is the most over the ranks, so every rank admits the same
    requests at the same steps."""
    got = [r[SKEWED] for r in runs["mesh"]]
    first = got[0]
    assert first["ranks_agree"]
    assert len(first["paged"]["admissions"]) == N_REQ
    for other in got[1:]:
        for kind in ("lockstep", "paged"):
            assert other[kind]["outputs"] == first[kind]["outputs"]
            assert other[kind]["decode_steps"] == first[kind]["decode_steps"]
            assert other[kind]["p99_ms"] == first[kind]["p99_ms"]
        assert other["paged"]["admissions"] == first["paged"]["admissions"]


@pytest.mark.parametrize("name", ["layer_graph", "grok"])
def test_layer_graph_and_moe_on_the_mesh_match_one_rank(runs, name):
    got, one = runs["mesh"][0][name], runs["one"][name]
    assert got["mesh"] == {"data": 2, "model": 2}
    for kind in ("lockstep", "paged"):
        assert got[kind]["outputs"] == one[kind]["outputs"], kind
        assert got[kind]["decode_steps"] == one[kind]["decode_steps"]
    assert got["ranks_agree"] and got["token_count_parity"]
    # per-op paged == dense decode bit for bit; the layer graph rounds
    # elsewhere (its diff is small, not 0), as on one rank
    assert got["bitwise_max_abs_diff"] <= 1e-5


def test_world_one_serves_on_the_unit_mesh(runs):
    one = runs["one"][("ff", None)]
    assert one["mesh"] == {"data": 1, "model": 1}
    assert one["ranks_agree"] and one["bitwise_identical"]
    assert not dist.is_initialized()


def test_torchrun_cli_writes_on_rank_zero_only(tmp_path):
    out = tmp_path / "serve.json"
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.serve",
         "--smoke", "--device", "cpu", "--dist-backend", "gloo",
         "--requests", "2", "--max-new", "2", "--json", str(out)],
        env=env, capture_output=True, text=True, timeout=120, cwd=tmp_path)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.count(f"wrote {out}") == 1, proc.stdout
    assert proc.stdout.count("bitwise diff") == 1, proc.stdout
    result = json.loads(out.read_text())
    assert result["mesh"] == {"data": 1, "model": 2}
    assert result["ranks_agree"] and result["bitwise_identical"]
    assert result["lockstep"]["outputs"] == result["paged"]["outputs"]


@pytest.mark.parametrize("device,world,cards,want", [
    ("cpu", 4, 0, "gloo"), ("cuda", 1, 1, "nccl"), ("cuda", 4, 4, "nccl"),
    ("cuda", 4, 1, "gloo_staged")])
def test_default_backend_follows_ranks_per_card(monkeypatch, device, world,
                                                cards, want):
    """``--dist-backend``'s default: NCCL where each rank has a card,
    gloo_staged where ranks share one (NCCL refuses that), gloo on the
    CPU."""
    from repro_torch.launch import mesh
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    assert mesh.default_backend(device, world) == want
