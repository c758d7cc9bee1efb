"""The compiled step's CPU-side parts, at smoke sizes with seeds from numpy:

* the sync-free KV scatters equal the reference's (``repro.runtime.
  paged_kv`` ``scatter_prefill`` / ``scatter_token``) exactly, sentinel
  table entries, inactive rows and lengths on a page edge included, and a
  decode step calls no op that sizes a tensor by its data (a host sync);
* the cast-once params tree (``model.cast_params``) gives the same logits
  bit for bit as the per-use cast, for prefill and three decode steps of
  the smoke qwen, rwkv6 and zamba2 configs in bf16;
* the kernels' scratch sizing is a pure function of the step's shapes
  that covers every call of the step, and a capture never allocates;
* the step wrapper's bookkeeping (``launch.steps.CompiledStep``) with a
  stand-in for CUDA graph capture: which signatures capture a new graph,
  which inputs are copied in, and the launch counts a replay adds.

The CUDA graphs themselves run only on the card (tests/test_torch_cuda.py
and chip_smoke.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

from repro.runtime import paged_kv as jpk
from repro_torch.configs.base import smoke_config
from repro_torch.kernels.ff_decode_attention import ops as dec_ops
from repro_torch.kernels.ff_layer import ops as layer_ops
from repro_torch.launch import serve as t_serve
from repro_torch.launch import steps as t_steps
from repro_torch.models import build_model
from repro_torch.models import layers as L
from repro_torch.runtime import paged_kv as tpk

N_STEPS, PAGE = 3, 4


def _kv(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


# ---------------------------------------------------------------------------
# sync-free scatters
# ---------------------------------------------------------------------------

NB, PG, KVH, HD = 6, 4, 2, 8
TOKEN_CASES = {
    # row 1 past its one page (sentinel), row 2 an inactive slot
    "sentinel_and_inactive": ([[3, 1], [5, NB], [NB, NB]], [6, 4, 0]),
    # lengths on a page edge: the first row of the next page
    "page_edge": ([[3, 1], [0, 2], [4, NB]], [4, 0, 4]),
    "all_kept": ([[3, 1], [0, 2], [4, 5]], [1, 6, 7]),
    "none_kept": ([[NB, NB], [NB, NB], [NB, NB]], [0, 5, 2]),
    # rows sharing the last block at one offset: only row 0 writes there
    "dropped_beside_kept": ([[NB - 1, 1], [NB, NB], [NB, NB]], [2, 2, 6]),
}


@pytest.mark.parametrize("case", sorted(TOKEN_CASES))
def test_scatter_token_sync_free_equals_reference(case):
    bt, lens = (np.array(x, np.int32) for x in TOKEN_CASES[case])
    rng = np.random.default_rng(sorted(TOKEN_CASES).index(case))
    pool = _kv(rng, NB, 2, PG, KVH, HD)
    k_new, v_new = _kv(rng, 3, KVH, HD), _kv(rng, 3, KVH, HD)
    ref = jpk.scatter_token(jnp.asarray(pool), jnp.asarray(bt),
                            jnp.asarray(lens), jnp.asarray(k_new),
                            jnp.asarray(v_new), n_blocks=NB)
    ours = tpk.scatter_token(torch.from_numpy(pool.copy()),
                             torch.from_numpy(bt), torch.from_numpy(lens),
                             torch.from_numpy(k_new),
                             torch.from_numpy(v_new), n_blocks=NB)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


PREFILL_CASES = {
    # row 0 reaches its sentinel, row 2 has no block
    "sentinel_rows": ([[4, 0, NB], [2, 5, 1], [NB, NB, NB]], [7, 12, 5]),
    # lengths on page edges (4, 8) and an empty row
    "page_edges": ([[4, 0, NB], [2, 5, 1], [3, NB, NB]], [4, 8, 0]),
    # every position kept: the pool's blocks all written
    "pool_full": ([[0, 1, 2], [3, 4, 5], [NB, NB, NB]], [12, 12, 0]),
}


@pytest.mark.parametrize("case", sorted(PREFILL_CASES))
def test_scatter_prefill_sync_free_equals_reference(case):
    bt, lens = (np.array(x, np.int32) for x in PREFILL_CASES[case])
    rng = np.random.default_rng(10 + sorted(PREFILL_CASES).index(case))
    n_layers, b, s_p = 2, 3, 12
    pool = _kv(rng, n_layers, NB, 2, PG, KVH, HD)
    k = _kv(rng, n_layers, b, s_p, KVH, HD)
    v = _kv(rng, n_layers, b, s_p, KVH, HD)
    ref = jpk.scatter_prefill(jnp.asarray(pool), jnp.asarray(k),
                              jnp.asarray(v), jnp.asarray(bt),
                              jnp.asarray(lens), page=PG, n_blocks=NB)
    for tables, lengths in ((bt, lens),
                            (torch.from_numpy(bt), torch.from_numpy(lens))):
        ours = tpk.scatter_prefill(torch.from_numpy(pool.copy()),
                                   torch.from_numpy(k), torch.from_numpy(v),
                                   tables, lengths, page=PG, n_blocks=NB)
        np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


class _SyncSpy(TorchFunctionMode):
    """Records the torch ops that size a tensor by its data or read a
    value to the host: each is a host sync on the card."""
    SYNCS = {"nonzero", "nonzero_static", "argwhere", "item", "tolist",
             "masked_select", "unique", "unique_consecutive", "cpu",
             "numpy", "__bool__", "__int__", "__float__", "repeat_interleave"}

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        name = getattr(func, "__name__", str(func))
        if name in self.SYNCS or (name == "where" and len(args) == 1):
            self.seen.append(name)
        return func(*args, **(kwargs or {}))


def _smoke(arch, dtype="bfloat16", **kw):
    cfg = smoke_config(arch).replace(compute_dtype=dtype, **kw)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    # off the bf16 grid everywhere, so a leaf cast where it is read in
    # f32 would change the logits
    rng = np.random.default_rng(3)
    params = L.tree_map(lambda t: t + torch.from_numpy(
        rng.standard_normal(tuple(t.shape)).astype(np.float32) * 1e-2),
        params)
    return cfg, model, params


def _decode_state(cfg, model, params, paged):
    """A dense or paged qwen decode cache after a prefill of two prompts
    (lengths 5 and 8, the second ending on a page edge)."""
    lens = np.array([5, 8], np.int32)
    toks = np.random.default_rng(4).integers(
        1, cfg.vocab, size=(2, 8)).astype(np.int32)
    _, dense = t_steps.make_prefill_step(model, compiled=False)(
        params, {"tokens": torch.from_numpy(toks)})
    n_pages = -(-(8 + N_STEPS) // PAGE)
    if paged:
        kv = tpk.PagedKVCache(
            n_layers=cfg.n_layers, n_blocks=2 * n_pages + 1, page=PAGE,
            kv_heads=cfg.n_kv_heads, head_dim=cfg.hd, n_slots=3,
            n_pages_max=n_pages, dtype=cfg.cdtype)
        for i, n in enumerate(lens):
            kv.admit(i, dense["k"][:, i], dense["v"][:, i], int(n),
                     n_pages * PAGE)
        kv.lengths[:2] = lens - 1          # slot 2 stays inactive
        tok = np.concatenate([toks[np.arange(2), lens - 1], [0]])
        return kv, torch.from_numpy(tok.astype(np.int32))
    cache = t_serve.pad_cache_to(dense, 8, n_pages * PAGE, 2)
    return cache, torch.from_numpy(toks[np.arange(2), lens - 1])


@pytest.mark.parametrize("path", ["dense", "paged", "layer_graph"])
def test_decode_step_has_no_host_sync(path):
    cfg, model, params = _smoke("qwen1_5_0p5b", "float32",
                                layer_graph=path == "layer_graph",
                                decode_block_kv=PAGE)
    state, tok = _decode_state(cfg, model, params, path == "paged")
    cache = state.cache_view() if path == "paged" else state
    lengths = (torch.from_numpy(state.lengths.copy()) if path == "paged"
               else torch.tensor([4, 7], dtype=torch.int32))
    decode = t_steps.make_decode_step(model, compiled=False)
    spy = _SyncSpy()
    with spy:
        decode(params, {"token": tok, "lengths": lengths}, cache)
    assert spy.seen == []


# ---------------------------------------------------------------------------
# weights cast once
# ---------------------------------------------------------------------------


def _generate(model, params, cfg):
    """Prefill of two 6-token prompts, then N_STEPS greedy decode steps:
    the logits of each."""
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        1, cfg.vocab, size=(2, 6)).astype(np.int32))
    prefill = t_steps.make_prefill_step(model)
    decode = t_steps.make_decode_step(model)
    logits, cache = prefill(params, {"tokens": toks})
    out = [logits]
    if cfg.family == "dense":
        cache = t_serve.pad_cache_to(cache, 6, 6 + N_STEPS, 2)
    elif cfg.family == "hybrid":
        cache = t_serve.pad_cache_to(cache, 6, 6 + N_STEPS,
                                     {"mamba": None, "attn": 1})
    cur = torch.argmax(logits, dim=-1).to(torch.int32)
    lengths = torch.full((2,), 6, dtype=torch.int32)
    for _ in range(N_STEPS):
        cur, lg, cache = decode(params, {"token": cur, "lengths": lengths},
                                cache)
        out.append(lg)
        lengths = lengths + 1
    return out


@pytest.mark.parametrize("arch", ["qwen1_5_0p5b", "rwkv6_7b",
                                  "zamba2_2p7b"])
def test_cast_once_params_give_the_same_logits(arch):
    cfg, model, params = _smoke(arch)
    cast = model.cast_params(params)
    kept = {path for path, leaf in L.tree_leaves(cast)
            if leaf.dtype == torch.float32}
    for path, leaf in L.tree_leaves(cast):
        f32 = any(path[:len(p)] == p for p in model.F32_LEAVES)
        assert leaf.dtype == (torch.float32 if f32 else torch.bfloat16), path
    assert kept and len(kept) < len(list(L.tree_leaves(cast)))
    want = _generate(model, params, cfg)
    got = _generate(model, cast, cfg)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == torch.bfloat16
        assert torch.equal(g, w)


# ---------------------------------------------------------------------------
# kernel scratch fixed before capture
# ---------------------------------------------------------------------------

# qwen1.5-0.5B's decode attention (B 4, 16 KV heads of 64, MHA) and
# zamba2's (32 heads of 80) at the serve and prompt-256 cache rows
DECODE_SHAPES = [(4, 16, 1, 64, torch.bfloat16, 48),
                 (4, 16, 1, 64, torch.bfloat16, 240),
                 (4, 32, 1, 80, torch.bfloat16, 272),
                 (1, 2, 6, 64, torch.float32, 4096)]


@pytest.mark.parametrize("shape", DECODE_SHAPES)
def test_decode_scratch_covers_every_call_of_the_step(shape):
    b, kvh, group, d, dtype, s = shape
    tickets, words = dec_ops.scratch_size(b, kvh, group, d, dtype, s, 132)
    assert (tickets, words) == dec_ops.scratch_size(b, kvh, group, d, dtype,
                                                    s, 132)
    plan = dec_ops._plan(b, kvh, d, dtype, s, 132)
    assert tickets == b * kvh
    # any lengths up to the cache's rows: no row uses more splits
    used = max(len(dec_ops._split_words(-(-n // plan.rows), plan.split,
                                        plan.rows))
               for n in range(s + 1))
    assert used <= plan.split
    if used > 1:
        assert words >= b * kvh * used * group * (d + 2)


def test_layer_ring_size_covers_the_tail_and_its_stages():
    m, d, hq, f = 4, 1024, 1024, 2816
    stages = [("matmul", d, hq), ("swiglu", f, d), ("matmul", d, f)]
    splits, words, tickets = layer_ops.ring_size(m, stages, 132)
    assert (splits, words, tickets) == layer_ops.ring_size(m, stages, 132)
    for kind, n, k in stages:
        (split,), w, t = layer_ops.ring_size(m, [(kind, n, k)], 132)
        assert split in splits and w <= words and t <= tickets
        assert t == layer_ops._plan(n, k, 132).tiles + 2


def test_scratch_is_never_allocated_during_capture(monkeypatch):
    dev = torch.device("cpu")
    monkeypatch.setattr(dec_ops, "_SCRATCH", {})
    monkeypatch.setattr(layer_ops, "_TICKETS", {})
    monkeypatch.setattr(layer_ops._build, "stream_ptr", lambda device: 7)
    capturing = {"on": False}
    monkeypatch.setattr(layer_ops._build, "capturing",
                        lambda device: capturing["on"])
    need = dec_ops.scratch_size(4, 16, 1, 64, torch.bfloat16, 240, 132)
    tickets, ws = dec_ops._scratch(dev, 7, *need)        # the warm-up
    lt = layer_ops._tickets(dev, 46)
    capturing["on"] = True
    t2, w2 = dec_ops._scratch(dev, 7, *need)             # the capture
    assert t2 is tickets and w2 is ws
    assert layer_ops._tickets(dev, 46) is lt
    with pytest.raises(RuntimeError, match="capture"):
        dec_ops._scratch(dev, 7, need[0], ws.numel() + 1)
    with pytest.raises(RuntimeError, match="capture"):
        layer_ops._tickets(dev, lt.numel() + 1)
    capturing["on"] = False
    bigger = layer_ops._tickets(dev, lt.numel() + 1)
    assert bigger.numel() > lt.numel() and any(
        r is lt for r in layer_ops._RETIRED)   # a graph may hold it


# ---------------------------------------------------------------------------
# the step wrapper's bookkeeping, with a stand-in for capture
# ---------------------------------------------------------------------------


def _stand_in(counter, per_replay):
    """A capture stand-in: warm up, reload, "capture" by running once, and
    replay by running again into the captured outputs' buffers."""
    calls = {"capture": 0}

    def capture(run, reload, device):
        calls["capture"] += 1
        run()
        reload()
        out = run()
        leaves = []
        t_steps._flatten(out, leaves)

        def replay():
            fresh = []
            t_steps._flatten(run(), fresh)
            for dst, src in zip(leaves, fresh):
                if not t_steps._same_buffer(dst, src):
                    dst.copy_(src)
        return replay, out, [(counter, per_replay)]
    return capture, calls


@pytest.mark.parametrize("paged", [False, True])
def test_compiled_step_bookkeeping_with_a_stand_in(paged):
    cfg, model, params = _smoke("qwen1_5_0p5b", "float32",
                                decode_block_kv=PAGE)
    counter = dec_ops.decode_attention
    capture, calls = _stand_in(counter, 5)
    eager = t_steps.make_decode_step(model, compiled=False)
    step = t_steps.CompiledStep(eager, capture=capture, devices=("cpu",))
    state, tok = _decode_state(cfg, model, params, paged)
    state_e, _ = _decode_state(cfg, model, params, paged)
    cache = state.cache_view() if paged else state
    cache_e = state_e.cache_view() if paged else state_e
    lengths = (torch.from_numpy(state.lengths.copy()) if paged
               else torch.tensor([4, 7], dtype=torch.int32))
    cur, cur_e, lens = tok, tok.clone(), lengths
    n0 = counter.launches
    for i in range(N_STEPS):
        cur, lg, cache = step(params, {"token": cur, "lengths": lens}, cache)
        cur_e, lg_e, cache_e = eager(
            params, {"token": cur_e, "lengths": lens.clone()}, cache_e)
        assert torch.equal(lg, lg_e) and torch.equal(cur, cur_e)
        # the first call copies every input in; later ones only the batch
        # (the next token is the previous call's output buffer, the
        # lengths a new tensor): the returned cache is the static buffer
        assert step.last_copies == (len(step.graphs[next(iter(
            step.graphs))].statics) if i == 0 else 2)
        if paged:
            state.update(cache)
            assert cache["kv_pool"] is state.pool
            cache = state.cache_view()
        lens = lens + (lens > 0).to(lens.dtype)    # inactive rows stay 0
    assert calls["capture"] == 1 and len(step.graphs) == 1
    assert counter.launches - n0 == 5 * N_STEPS
    # a new cache of the same shapes: the same graph, its leaves copied in
    fresh, _ = _decode_state(cfg, model, params, paged)
    step(params, {"token": cur, "lengths": lens},
         fresh.cache_view() if paged else fresh)
    assert calls["capture"] == 1 and step.last_copies > 2
    # another batch shape, or another params tree: a new graph each
    twin = L.tree_map(torch.clone, params)
    step(twin, {"token": cur, "lengths": lens}, cache)
    assert calls["capture"] == 2
    if not paged:
        longer = {k: torch.nn.functional.pad(x, (0, 0, 0, 0, 0, PAGE))
                  for k, x in cache.items()}
        step(params, {"token": cur, "lengths": lens}, longer)
        assert calls["capture"] == 3 and len(step.graphs) == 3


def test_compiled_step_runs_eagerly_off_its_devices():
    cfg, model, params = _smoke("qwen1_5_0p5b", "float32")
    step = t_steps.make_decode_step(model)
    assert isinstance(step, t_steps.CompiledStep)
    assert step is t_steps.make_decode_step(model)   # shared, as a jit's
    tok = torch.tensor([3, 4], dtype=torch.int32)
    lens = torch.tensor([2, 5], dtype=torch.int32)
    cache = {k: torch.zeros(cfg.n_layers, 2, 8, cfg.n_kv_heads, cfg.hd)
             for k in ("k", "v")}
    step(params, {"token": tok, "lengths": lens}, cache)
    assert step.graphs == {}
    assert torch.count_nonzero(cache["k"]) > 0       # written in place


def test_paged_cache_keeps_one_device_table():
    kv = tpk.PagedKVCache(n_layers=2, n_blocks=6, page=4, kv_heads=2,
                          head_dim=8, n_slots=3, n_pages_max=3)
    view = kv.cache_view()
    rng = np.random.default_rng(6)
    kv.admit(1, torch.from_numpy(_kv(rng, 2, 8, 2, 8)),
             torch.from_numpy(_kv(rng, 2, 8, 2, 8)), 5, 9)
    again = kv.cache_view()
    assert again["block_tables"].data_ptr() == \
        view["block_tables"].data_ptr()
    assert again["block_tables"].stride()[0] == 0
    np.testing.assert_array_equal(again["block_tables"][1].numpy(),
                                  kv._tables)
    kv.retire(1)
    np.testing.assert_array_equal(view["block_tables"][0].numpy(),
                                  np.full((3, 3), 6))


# ---------------------------------------------------------------------------
# the VLM and encoder-decoder steps
# ---------------------------------------------------------------------------


def _new_family_state(arch):
    """The smoke internvl2 (prefill batch with ``image_embeds``) or
    whisper (with ``frames``) model in f32, its prefill batch, and its
    decode cache padded by N_STEPS rows."""
    cfg, model, params = _smoke(arch, "float32")
    rng = np.random.default_rng(6)
    batch = {"tokens": torch.from_numpy(rng.integers(
        1, cfg.vocab, size=(2, 5)).astype(np.int32))}
    if cfg.family == "vlm":
        batch["image_embeds"] = torch.from_numpy(rng.standard_normal(
            (2, cfg.n_patches, cfg.d_model)).astype(np.float32))
        s, dims = 5 + cfg.n_patches, 2
    else:
        batch["frames"] = torch.from_numpy(rng.standard_normal(
            (2, cfg.n_frames, cfg.d_model)).astype(np.float32))
        s, dims = 5, {"self": 2, "cross": None}
    logits, cache = t_steps.make_prefill_step(model, compiled=False)(
        params, batch)
    cache = t_serve.pad_cache_to(cache, s, s + N_STEPS, dims)
    return model, params, batch, logits, cache, s


@pytest.mark.parametrize("arch", ["internvl2_1b", "whisper_tiny"])
def test_new_family_decode_step_has_no_host_sync(arch):
    """The VLM's decode and whisper's (its self-attention append by
    ``_write_token``, the learned position gathered by ``lengths``) read
    nothing back to the host."""
    model, params, _, logits, cache, s = _new_family_state(arch)
    decode = t_steps.make_decode_step(model, compiled=False)
    spy = _SyncSpy()
    with spy:
        decode(params, {"token": torch.argmax(logits, -1).to(torch.int32),
                        "lengths": torch.full((2,), s, dtype=torch.int32)},
               cache)
    assert spy.seen == []


@pytest.mark.parametrize("arch", ["internvl2_1b", "whisper_tiny"])
def test_compiled_new_family_steps_with_a_stand_in(arch):
    """CompiledStep over the VLM prefill ({"tokens", "image_embeds"}),
    whisper's prefill ({"tokens", "frames"}) and whisper's decode (the
    {"self", "cross"} cache): one capture a signature, and each replay
    equal to the eager step bit for bit."""
    model, params, batch, _, cache, s = _new_family_state(arch)
    cache_e = _new_family_state(arch)[4]
    counter = dec_ops.decode_attention
    capture, calls = _stand_in(counter, 0)
    prefill_e = t_steps.make_prefill_step(model, compiled=False)
    prefill = t_steps.CompiledStep(prefill_e, capture=capture,
                                   devices=("cpu",))
    for _ in range(2):
        lg, _ = prefill(params, batch)
        lg_e, _ = prefill_e(params, batch)
        assert torch.equal(lg, lg_e)
    assert calls["capture"] == 1
    decode_e = t_steps.make_decode_step(model, compiled=False)
    decode = t_steps.CompiledStep(decode_e, capture=capture,
                                  devices=("cpu",))
    cur = cur_e = torch.argmax(lg_e, -1).to(torch.int32)
    lens = torch.full((2,), s, dtype=torch.int32)
    for _ in range(N_STEPS):
        cur, lg, cache = decode(params, {"token": cur, "lengths": lens},
                                cache)
        cur_e, lg_e, cache_e = decode_e(
            params, {"token": cur_e, "lengths": lens.clone()}, cache_e)
        assert torch.equal(lg, lg_e) and torch.equal(cur, cur_e)
        lens = lens + 1
    assert calls["capture"] == 2
    got, want = [], []
    t_steps._flatten(cache, got)
    t_steps._flatten(cache_e, want)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_capture_runs_with_the_collector_off(monkeypatch):
    """A model and its compiled steps form a cycle, so a dropped model's
    graphs are freed by the cyclic collector; a graph freed while another
    is being captured invalidates that capture. ``_cuda_capture`` (here on
    stand-ins for the CUDA stream and graph calls) keeps the collector
    off inside the capture and turns it back on after, also when the
    capture raises."""
    import contextlib
    import gc

    class Stream:
        def wait_stream(self, other):
            pass

    class Graph:
        def replay(self):
            pass

    seen = []

    @contextlib.contextmanager
    def graph(g, pool, stream):
        seen.append(("capture", gc.isenabled()))
        yield

    dev = torch.device("cpu")
    monkeypatch.setitem(t_steps._STREAMS, dev, Stream())
    monkeypatch.setitem(t_steps._POOLS, dev, ())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda d: Stream())
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "CUDAGraph", Graph)
    monkeypatch.setattr(torch.cuda, "graph", graph)
    assert gc.isenabled()

    def run():
        seen.append(("run", gc.isenabled()))
        if len(seen) == 6:          # the second capture
            raise RuntimeError("capture failed")
        return torch.zeros(1)

    t_steps._cuda_capture(run, lambda: None, dev)
    assert seen == [("run", True), ("capture", False), ("run", False)]
    assert gc.isenabled()
    with pytest.raises(RuntimeError, match="capture failed"):
        t_steps._cuda_capture(run, lambda: None, dev)
    assert seen[3:] == [("run", True), ("capture", False), ("run", False)]
    assert gc.isenabled()
