"""The port's graph entry points ``attention_proj`` and
``moe_dispatch_ffn`` and the staged paged-decode baseline (their plain
versions, which the wrappers run for CPU tensors) against the reference's
fused StreamGraphs in interpret mode (``PipePolicy(mode="ff",
interpret=True)``), its ``_ref`` oracles and its ``_paged_unfused``, on
the same numpy inputs.

Tolerances: float32 5e-4 relative and absolute (the reference registry's
``tol`` for both graphs; the paged pair 2e-4, its ``tol``); bfloat16 2e-2
relative and absolute against the reference's fused entry points, whose
roundings the port's plain versions copy (the f32 ``_ref`` oracles round
once, at the end, so in bfloat16 they are not the yardstick). Every
reference output is computed once per module: interpret mode is slow.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.program import PipePolicy
from repro.models import layers as JL
from repro.models import moe as JM
from repro.runtime import paged_kv as JPK
from repro_torch.kernels.ff_attention import attention_proj_ref
from repro_torch.models import layers as TL
from repro_torch.models import moe as TM
from repro_torch.runtime import paged_kv as TPK

POLICY = PipePolicy(mode="ff", interpret=True)
TOL = {torch.float32: 5e-4, torch.bfloat16: 2e-2}
PAGED_TOL = 2e-4
_JNP = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
DTYPES = [torch.float32, torch.bfloat16]


def _close(port, ref, tol):
    np.testing.assert_allclose(port.float().numpy(),
                               np.asarray(ref, np.float32), rtol=tol,
                               atol=tol)


def _pair(x, dtype):
    t = torch.from_numpy(np.ascontiguousarray(x)).to(dtype)
    return t, jnp.asarray(t.float().numpy(), _JNP[dtype])


# ---------------------------------------------------------------------------
# attention -> out-projection
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def attn_proj_case():
    """bh 2, S 128 (the reference's KV tile is 128), d 32, d_out 64; per
    dtype the port's operands, the reference's fused output and its f32
    oracle."""
    rng = np.random.default_rng(0)
    bh, s, d, d_out = 2, 128, 32, 64
    raw = (0.3 * rng.standard_normal((bh, s, d)),
           0.3 * rng.standard_normal((bh, s, d)),
           rng.standard_normal((bh, s, d)),
           rng.standard_normal((d, d_out)) / np.sqrt(d))
    case = {}
    for dtype in DTYPES:
        port, ref = zip(*(_pair(x, dtype) for x in raw))
        case[dtype] = (port, np.asarray(JL.attention_proj(*ref,
                                                          policy=POLICY)),
                       np.asarray(JL._attention_proj_ref(*ref)))
    return case


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_attention_proj_matches_reference_graph(attn_proj_case, dtype):
    args, fused, _ = attn_proj_case[dtype]
    out = TL.attention_proj(*args)
    assert out.dtype == dtype and out.shape == fused.shape
    _close(out, fused, TOL[dtype])


def test_attention_proj_f32_matches_reference_oracle(attn_proj_case):
    args, _, oracle = attn_proj_case[torch.float32]
    _close(TL.attention_proj(*args), oracle, TOL[torch.float32])
    _close(TL._attention_proj_ref(*args), oracle, TOL[torch.float32])


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_attention_proj_unfused_is_the_fused_plain_version(attn_proj_case,
                                                           dtype):
    """On the CPU both run the same plain versions: the unfused pair
    (attention, then matmul) equals the fused entry bit for bit, as the
    kernels are held to on the card."""
    args, _, _ = attn_proj_case[dtype]
    out = TL.attention_proj(*args)
    assert torch.equal(out, TL._attention_proj_unfused(*args))
    assert torch.equal(out, attention_proj_ref(*args))


def test_attention_proj_bf16_rounds_where_the_graph_rounds(attn_proj_case):
    """In bf16 the graph writes the attention output in bf16 before the
    product, the f32 oracle does not: the port follows the graph, so it is
    closer to the fused reference than to the oracle's single rounding."""
    args, fused, oracle = attn_proj_case[torch.bfloat16]
    out = TL.attention_proj(*args).float().numpy()
    to_graph = np.abs(out - fused.astype(np.float32)).max()
    to_oracle = np.abs(out - oracle.astype(np.float32)).max()
    assert to_graph < to_oracle


# ---------------------------------------------------------------------------
# MoE dispatch -> expert -> combine
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def moe_case():
    """T 48 tokens, 32 dispatched rows (repeated, unsorted), d 64, d_ff
    128, 32 combined rows: multiples of the 32-row bundle the reference's
    planner picks at this size."""
    rng = np.random.default_rng(1)
    t, n, d, f, t_out = 48, 32, 64, 128, 32
    idx = rng.integers(0, t, n).astype(np.int32)
    comb = rng.integers(0, n, t_out).astype(np.int32)
    tokens = rng.standard_normal((t, d))
    w1 = rng.standard_normal((d, f)) / np.sqrt(d)
    case = {}
    for dtype in DTYPES:
        (tt, jt), (tw, jw) = _pair(tokens, dtype), _pair(w1, dtype)
        ji, jc = jnp.asarray(idx), jnp.asarray(comb)
        port = (torch.from_numpy(idx), tt, tw, torch.from_numpy(comb))
        case[dtype] = (port, np.asarray(JM.moe_dispatch_ffn(
            ji, jt, jw, jc, policy=POLICY)), np.asarray(JM._moe_graph_ref(
                ji, jt, jw, jc)))
    return case


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_moe_dispatch_ffn_matches_reference_graph(moe_case, dtype):
    args, fused, oracle = moe_case[dtype]
    out = TM.moe_dispatch_ffn(*args)
    assert out.dtype == dtype and out.shape == fused.shape
    _close(out, fused, TOL[dtype])
    _close(out, oracle, TOL[dtype])     # the oracle rounds as the graph


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_moe_unfused_and_plain_equal_the_entry(moe_case, dtype):
    args, _, _ = moe_case[dtype]
    out = TM.moe_dispatch_ffn(*args)
    assert torch.equal(out, TM._moe_graph_unfused(*args))
    assert torch.equal(out, TM.moe_dispatch_ffn_ref(*args))


@pytest.mark.parametrize("n,t_out", [(12, 16), (16, 20)])
def test_moe_dispatch_ffn_wants_multiples_of_8(moe_case, n, t_out):
    (idx, tokens, w1, comb), _, _ = moe_case[torch.float32]
    with pytest.raises(ValueError, match="multiples"):
        TM.moe_dispatch_ffn(idx[:n], tokens, w1, comb[:t_out])


# ---------------------------------------------------------------------------
# staged paged decode
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def paged_case():
    """The reference's own smoke point of its paged graph (b 2, KVH 2,
    group 8, 4 pages of 16, d 64, 12-block pool, lengths 37 and 64), its
    staged baseline's output and its oracle's, and the block table the
    index stream was made from."""
    key = jax.random.PRNGKey(0)
    idx, table, lens, q = JPK._paged_inputs(key)
    c = JPK._SMOKE
    perm = jax.random.permutation(jax.random.fold_in(key, 1), c["nb"])
    bt = np.asarray(perm[:c["b"] * c["n_pages"]]).reshape(
        c["b"], c["n_pages"]).astype(np.int32)
    return dict(c=c, bt=bt, idx=np.array(idx), table=np.array(table),
                lens=np.array(lens), q=np.array(q),
                unfused=np.asarray(JPK._paged_unfused(idx, table, lens, q)),
                oracle=np.asarray(JPK._paged_ref(idx, table, lens, q)))


def _port_paged(case):
    c = case["c"]
    b, kvh, g, d = case["q"].shape
    pool = torch.from_numpy(case["table"]).view(c["nb"], 2, c["page"], kvh, d)
    q = torch.from_numpy(case["q"]).reshape(b, kvh * g, d)
    bt = torch.from_numpy(case["bt"])
    idx = TPK.gather_indices(bt, page=c["page"], kv_heads=kvh,
                             n_blocks=c["nb"])
    return q, pool, bt, idx, torch.from_numpy(case["lens"])


def test_gather_indices_are_the_reference_rows_k_before_v(paged_case):
    """The same rows as the reference's index stream, reordered from
    [B, KVH, n_pages, 2, page] to [2, B, KVH, n_pages, page]."""
    c = paged_case["c"]
    _, _, _, idx, _ = _port_paged(paged_case)
    ref = paged_case["idx"].reshape(c["b"], c["kvh"], c["n_pages"], 2,
                                    c["page"]).transpose(3, 0, 1, 2, 4)
    assert idx.dtype == torch.int32
    assert np.array_equal(idx.numpy(), ref.reshape(-1))


def test_gather_indices_clip_sentinels_as_the_reference(paged_case):
    c = paged_case["c"]
    bt = paged_case["bt"].copy()
    bt[0, 3] = c["nb"]                               # sentinel
    ref = JPK.gather_indices(bt, page=c["page"], kv_heads=c["kvh"],
                             n_blocks=c["nb"])
    port = TPK.gather_indices(torch.from_numpy(bt), page=c["page"],
                              kv_heads=c["kvh"], n_blocks=c["nb"])
    ref = np.asarray(ref).reshape(c["b"], c["kvh"], c["n_pages"], 2,
                                  c["page"]).transpose(3, 0, 1, 2, 4)
    assert np.array_equal(port.numpy(), ref.reshape(-1))


def test_staged_paged_decode_matches_reference(paged_case):
    q, pool, _, idx, lens = _port_paged(paged_case)
    out = TPK.paged_decode_unfused(q, pool, idx, lens)
    b, kvh, g, d = paged_case["q"].shape
    out = out.view(b, kvh, g, d)
    _close(out, paged_case["unfused"], PAGED_TOL)
    _close(out, paged_case["oracle"], PAGED_TOL)


def test_staged_paged_decode_equals_fused_bitwise(paged_case):
    q, pool, bt, idx, lens = _port_paged(paged_case)
    assert torch.equal(TPK.paged_decode_unfused(q, pool, idx, lens),
                       TPK.paged_decode_attention(q, pool, bt, lens))
