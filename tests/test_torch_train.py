"""The port's training driver and what it stands on, on the CPU.

- the checkpointer: the manifest (step, extra, shape, dtype and sha256 per
  leaf), the ``arrays.npz`` keys and bytes and ``LATEST`` equal to the
  reference's ``save`` of the same numpy tree; each package restores the
  other's checkpoint; tensors on any device and ``meta`` stand-ins;
  ``keep_last`` and crashed partial writes swept; a tampered leaf refused;
- the data: ``batch_at`` equal to the reference's bit for bit, and the
  host pipe delivering in step order from any start;
- the supervisor: resume after an injected failure, one save on a
  preempted boundary, the previous SIGTERM handler restored, the plan
  snapshot carried by every checkpoint and pre-warmed on resume;
- the straggler policies: the port's watchdog and rebalancer take the
  reference's actions on the same step times;
- the driver: learning at smoke width with the reference test's settings,
  a run killed at step 12 and resumed to 20 equal to a clean run bit for
  bit, the plan and telemetry flags, Adafactor (grok-1), and
  ``--mesh pod`` refused.
"""

import json
import os
import signal

import numpy as np
import pytest
import torch

from repro.checkpoint import restore as j_restore
from repro.checkpoint import save as j_save
from repro.data import HostPipeline as JPipe
from repro.data import SyntheticSpec as JSpec
from repro.data import batch_at as j_batch_at
from repro.runtime import stragglers as j_strag
from repro_torch.checkpoint import latest_step, restore, save, save_async
from repro_torch.core import autotune
from repro_torch.data import HostPipeline, SyntheticSpec, batch_at
from repro_torch.launch import train
from repro_torch.runtime import stragglers as t_strag
from repro_torch.runtime.fault_tolerance import FTConfig, Supervisor


def _tree():
    rng = np.random.default_rng(0)
    return {"params": {"w": rng.standard_normal((3, 4)).astype(np.float32),
                       "b": np.arange(4, dtype=np.int32),
                       "z": {"deep": rng.standard_normal(5)}},
            "opt": {"step": np.asarray(7, np.int32)},
            "data_step": np.asarray(12, np.int64)}


def _read(d, step):
    base = os.path.join(d, f"step_{step:08d}")
    with open(os.path.join(base, "manifest.json")) as f:
        manifest = json.load(f)
    with np.load(os.path.join(base, "arrays.npz")) as z:
        arrays = {k: z[k] for k in z.files}
    with open(os.path.join(d, "LATEST")) as f:
        latest = f.read()
    return manifest, arrays, latest


def test_checkpoint_layout_matches_reference(tmp_path):
    tree, extra = _tree(), {"plan_snapshot": {"format": 3, "plans": {}}}
    j_save(str(tmp_path / "j"), 5, tree, extra=extra)
    save(str(tmp_path / "t"), 5, tree, extra=extra)
    jm, ja, jl = _read(str(tmp_path / "j"), 5)
    tm, ta, tl = _read(str(tmp_path / "t"), 5)
    assert tm == jm and tl == jl
    assert list(ta) == list(ja) == list(tm["leaves"])
    for k in ja:
        assert ta[k].dtype == ja[k].dtype
        np.testing.assert_array_equal(ta[k], ja[k])
    # torch leaves write the same bytes as their numpy arrays
    as_torch = {"params": {"w": torch.from_numpy(tree["params"]["w"]),
                           "b": torch.from_numpy(tree["params"]["b"]),
                           "z": {"deep": torch.from_numpy(
                               tree["params"]["z"]["deep"])}},
                "opt": {"step": torch.tensor(7, dtype=torch.int32)},
                "data_step": tree["data_step"]}
    save(str(tmp_path / "tt"), 5, as_torch, extra=extra)
    assert _read(str(tmp_path / "tt"), 5)[0] == jm


def test_checkpoints_restore_across_packages(tmp_path):
    tree = _tree()
    j_save(str(tmp_path / "j"), 3, tree)
    save(str(tmp_path / "t"), 3, tree)
    like = {"params": {"w": torch.empty(3, 4, device="meta"),
                       "b": torch.empty(4, dtype=torch.int32,
                                        device="meta"),
                       "z": {"deep": torch.empty(5, dtype=torch.float64,
                                                 device="meta")}},
            "opt": {"step": torch.zeros((), dtype=torch.int32)},
            "data_step": np.zeros((), np.int64)}
    got, step, extra = restore(str(tmp_path / "j"), like)
    assert step == 3 and extra == {}
    assert got["params"]["w"].device.type == "cpu"
    np.testing.assert_array_equal(got["params"]["w"].numpy(),
                                  tree["params"]["w"])
    assert isinstance(got["data_step"], np.ndarray)
    assert int(got["data_step"]) == 12 and int(got["opt"]["step"]) == 7
    back, step, _ = j_restore(str(tmp_path / "t"), tree)
    for k in ("w", "b"):
        np.testing.assert_array_equal(np.asarray(back["params"][k]),
                                      tree["params"][k])
    bad = dict(like, data_step=np.zeros((2,), np.int64))
    with pytest.raises(ValueError, match="data_step"):
        restore(str(tmp_path / "t"), bad)


def test_checkpoint_gc_async_and_checksum(tmp_path):
    d = str(tmp_path)
    os.makedirs(os.path.join(d, "step_00000099.tmp-1"))   # a crashed write
    for s in range(1, 6):
        save(d, s, {"x": np.full(3, s, np.float32)}, keep_last=2)
    assert sorted(os.listdir(d)) == ["LATEST", "step_00000004",
                                     "step_00000005"]
    save_async(d, 6, {"x": torch.full((3,), 6.0)}).join()
    assert latest_step(d) == 6
    got, _, _ = restore(d, {"x": torch.zeros(3)})
    assert got["x"].tolist() == [6.0] * 3
    path = os.path.join(d, "step_00000006", "arrays.npz")
    np.savez(path, x=np.zeros(3, np.float32))               # tamper
    with pytest.raises(IOError, match="checksum"):
        restore(d, {"x": torch.zeros(3)})
    assert latest_step(str(tmp_path / "none")) is None
    with pytest.raises(FileNotFoundError):
        restore(str(tmp_path / "none"), {"x": torch.zeros(3)})


@pytest.mark.parametrize("frames,patches", [(0, 0), (4, 0), (0, 3)])
def test_batches_match_reference(frames, patches):
    kw = dict(vocab=97, seq_len=12, global_batch=3, seed=4, n_frames=frames,
              n_patches=patches, d_model=8)
    for step in (0, 1, 17):
        want = j_batch_at(JSpec(**kw), step)
        got = batch_at(SyntheticSpec(**kw), step)
        assert list(got) == list(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("producers,start", [(1, 0), (3, 5)])
def test_host_pipeline_delivers_in_step_order(producers, start):
    fn = (lambda s: {"s": np.asarray(s)})
    got = []
    for cls in (HostPipeline, JPipe):
        pipe = cls(fn, depth=2, producers=producers, start_step=start)
        try:
            got.append([int(pipe.get()["s"]) for _ in range(9)])
            assert pipe.state == start + 9
        finally:
            pipe.stop()
    assert got[0] == got[1] == list(range(start, start + 9))


def _counter_step(state, step):
    return {"x": state["x"] + step + 1}


def test_supervisor_resume_after_injected_failure(tmp_path):
    cfg = FTConfig(ckpt_dir=str(tmp_path), ckpt_every=3,
                   handle_sigterm=False)
    sup = Supervisor(cfg, {"x": np.zeros((), np.int64)}, fail_at_step=7)
    state, start = sup.resume()
    assert start == 0
    with pytest.raises(RuntimeError, match="injected failure at step 7"):
        sup.run(state, start, 10, _counter_step)
    sup2 = Supervisor(cfg, {"x": np.zeros((), np.int64)})
    state, start = sup2.resume()
    assert start == 6
    final = sup2.run(state, start, 10, _counter_step)
    assert int(final["x"]) == sum(range(1, 11))
    assert sup2.last_save["step"] == 10 and sup2.last_save["bytes"] > 0


def test_supervisor_with_ckpt_every_zero_writes_no_checkpoint(tmp_path):
    cfg = FTConfig(ckpt_dir=str(tmp_path), ckpt_every=0,
                   handle_sigterm=False)
    sup = Supervisor(cfg, {"x": np.zeros((), np.int64)})
    final = sup.run({"x": np.zeros((), np.int64)}, 0, 5, _counter_step)
    assert int(final["x"]) == sum(range(1, 6))
    assert sup.last_save is None and latest_step(str(tmp_path)) is None


def test_supervisor_sigterm_drain_and_handler_restore(tmp_path):
    sentinel = lambda *_: None                  # noqa: E731
    prev = signal.signal(signal.SIGTERM, sentinel)
    try:
        cfg = FTConfig(ckpt_dir=str(tmp_path), ckpt_every=3,
                       plan_snapshot=False)
        with Supervisor(cfg, {"x": np.zeros((), np.int64)}) as sup:
            assert signal.getsignal(signal.SIGTERM) == sup._on_sigterm

            def on_step(step, _state):
                if step == 6:                   # a ckpt_every boundary
                    os.kill(os.getpid(), signal.SIGTERM)
            final = sup.run({"x": np.zeros((), np.int64)}, 0, 20,
                            _counter_step, on_step=on_step)
        assert signal.getsignal(signal.SIGTERM) is sentinel
        sup.close()
        assert signal.getsignal(signal.SIGTERM) is sentinel
    finally:
        signal.signal(signal.SIGTERM, prev)
    assert sup.preempted and int(final["x"]) == sum(range(1, 7))
    assert sup.save_count == 2 and latest_step(str(tmp_path)) == 6


def test_checkpoint_carries_plan_snapshot(tmp_path):
    key = (f"ff_fake|H100_SXM|float32|fmt{autotune.PLAN_FORMAT_VERSION}"
           f"|meshsingle|dev1||tile...")
    rec = {"tile": [128, 128], "depth": 2, "streams": 1, "mesh": "single",
           "ms": 0.5}
    cfg = FTConfig(ckpt_dir=str(tmp_path / "ckpt"), ckpt_every=2,
                   handle_sigterm=False)
    autotune.tuned_cache_clear()
    try:
        with autotune.tuning_config(cache_path=str(tmp_path / "a.json")):
            autotune._MEM[(autotune.cache_path(), key)] = rec
            Supervisor(cfg, {"x": np.zeros((), np.int64)}).run(
                {"x": np.zeros((), np.int64)}, 0, 2, _counter_step)
        with open(tmp_path / "ckpt" / "step_00000002" / "manifest.json") as f:
            snap = json.load(f)["extra"]["plan_snapshot"]
        assert snap["format"] == autotune.PLAN_FORMAT_VERSION
        assert snap["plans"][key] == rec
        autotune.tuned_cache_clear()            # "another host"
        with autotune.tuning_config(cache_path=str(tmp_path / "b.json")):
            sup = Supervisor(cfg, {"x": np.zeros((), np.int64)})
            _, start = sup.resume()
            assert start == 2 and sup.resume_prewarmed == 1
            assert autotune._MEM[(autotune.cache_path(), key)] == rec
            assert autotune._MEM_ORIGIN[(autotune.cache_path(), key)] == \
                "snapshot"
            with pytest.warns(RuntimeWarning, match="format"):
                assert autotune.restore_snapshot(
                    {"format": -1, "plans": {key: rec}}) == 0
    finally:
        autotune.tuned_cache_clear()


def _straggler_run(mod, cfg_kw, hosts, times, hooks=False):
    log = []
    rb = (mod.BatchRebalancer({h: 4 for h in hosts}, min_share=1,
                              replan=lambda h, s: log.append((h, s)) or s)
          if hooks else None)
    wd = mod.StragglerWatchdog(mod.StragglerConfig(**cfg_kw), hosts,
                               rebalancer=rb,
                               on_replace=lambda h: log.append(h) or "ok")
    acts = [wd.step(t) if hooks else wd.observe_step(t) for t in times]
    return acts, wd.hosts, wd.evicted, wd.mitigations, log, wd._threshold()


@pytest.mark.parametrize("hooks", [False, True])
def test_straggler_policies_match_reference(hooks):
    hosts = [f"h{i}" for i in range(6)]
    times = []
    for i in range(30):
        jitter = 0.01 * ((i * 7) % 5 - 2) / 2.0
        t = {h: 1.0 + jitter for h in hosts}
        if 3 <= i:
            t["h2"] = 1.3 + jitter              # slow, below 1.5 x median
        if i == 8:
            t["h4"] = 3.0                       # one blip
        times.append(t)
    cfg_kw = dict(window=16, slow_factor=1.5, mad_factor=5.0, tolerate=2,
                  evict_after=6, hot_spares=1)
    want = _straggler_run(j_strag, cfg_kw, hosts, times, hooks)
    got = _straggler_run(t_strag, cfg_kw, hosts, times, hooks)
    assert got == want
    if hooks:                                   # evicted in the end
        assert "h2" in got[2] and got[4][-1] == "h2"
    else:                                       # the policy's actions only
        assert got[0][-1]["h2"] == "replace" and not got[2]
    for vals in ([3.0, 1.0, 2.0], [4.0, 1.0, 3.0, 2.0], []):
        assert t_strag._median(vals) == j_strag._median(vals)


def _args(tmp, **kw):
    argv = ["--ckpt-dir", str(tmp), "--device", "cpu"]
    for k, v in kw.items():
        flag = "--" + k.replace("_", "-")
        argv += [flag] if v is True else [flag, str(v)]
    return train.build_parser().parse_args(argv)


def test_train_driver_learns(tmp_path, capsys):
    """The reference's test_train_driver_learns settings: the synthetic
    Markov stream is learnable."""
    train.main(["--arch", "qwen1_5_0p5b", "--smoke", "--steps", "200",
                "--batch", "4", "--seq", "64", "--lr", "1e-2", "--ckpt-dir",
                str(tmp_path / "ck"), "--ckpt-every", "500", "--log-every",
                "10", "--device", "cpu"])
    out = capsys.readouterr().out
    losses = [float(line.split("loss=")[1].split()[0])
              for line in out.splitlines() if "loss=" in line]
    assert len(losses) == 20
    assert np.mean(losses[-2:]) < np.mean(losses[:2]) - 0.2, losses
    assert "done at step 200; median step" in out


def test_training_killed_and_resumed_is_identical(tmp_path):
    """Crash at step 12, resume to 20; a clean 20 steps beside it: every
    leaf of step 20's arrays.npz equal bit for bit (the reference test's
    settings)."""
    kw = dict(arch="qwen1_5_0p5b", smoke=True, steps=20, batch=2, seq=32,
              ckpt_every=5, log_every=1)
    a, b = tmp_path / "crash", tmp_path / "clean"
    with pytest.raises(RuntimeError, match="injected failure at step 12"):
        train.run(_args(a, fail_at=12, **kw))
    r = train.run(_args(a, **kw))
    assert r["start"] == 10 and len(r["metrics"]) == 10
    train.run(_args(b, **kw))
    assert latest_step(str(a)) == latest_step(str(b)) == 20
    za = np.load(a / "step_00000020" / "arrays.npz")
    zb = np.load(b / "step_00000020" / "arrays.npz")
    assert za.files == zb.files and "opt/step" in za.files
    for k in za.files:
        np.testing.assert_array_equal(za[k], zb[k], err_msg=k)
    assert int(za["data_step"]) == 20 and int(za["opt/step"]) == 20


def test_driver_flags_adafactor_and_meshes(tmp_path, capsys):
    """grok-1 (Adafactor) with accumulation, the plan and telemetry flags;
    a resumed run that has nothing left to do; --mesh pod refused at one
    rank (it needs 256)."""
    metrics = tmp_path / "metrics.json"
    kw = dict(arch="grok1_314b", smoke=True, steps=3, batch=4, seq=16,
              accum=2, quantized_accum=True, policy_mode="ff",
              metrics_json=metrics, record_profile=tmp_path / "prof.json",
              log_every=1)
    r = train.run(_args(tmp_path / "ck", **kw))
    assert [m.keys() for m in r["metrics"]][0] == {"loss", "aux", "lr"}
    assert all(np.isfinite(m["loss"]) for m in r["metrics"])
    st = r["state"]["opt"]
    assert set(st) == {"v", "step"} and int(st["step"]) == 3
    snap = json.loads(metrics.read_text())
    assert snap["counters"]["supervisor_saves_total"]
    assert (tmp_path / "prof.json").exists()
    r = train.run(_args(tmp_path / "ck", **kw))
    assert r["start"] == 3 and r["step_s"] == []
    with pytest.raises(SystemExit, match="needs 256 ranks"):
        train.run(_args(tmp_path / "pod", mesh="pod"))
    out = capsys.readouterr().out
    assert "resumed from checkpoint at step 3" in out
