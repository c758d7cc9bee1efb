"""The reference's chunked scan formulation (the port of
``chunk_scan_xla`` and its intra-chunk terms in
``repro/kernels/ff_chunk_scan/ref.py``), in plain PyTorch on any device.

This is the ``scan_impl="xla"`` / ``"xla_tiled"`` path of the models, not
a kernel: the reference runs it as XLA ops. It implements

    h_t = diag(w_t) h_{t-1} + k_t (x) v_t
    inclusive:  y_t = q_t . h_t
    exclusive:  y_t = q_t . (h_{t-1} + diag(u) k_t (x) v_t)

with the chunks' transitions composed in order (the reference's
``associative_scan`` composes the same transitions as a tree: the sums
differ only in rounding). Where the reference asks for f32 accumulation of
low-precision operands (``preferred_element_type``), the operands are
rounded to their type and multiplied in f32, which is the same product.
The naive per-step oracle is ``ops.chunk_scan_ref``.
"""

from __future__ import annotations

import torch


def _mm(eq: str, *xs, cd: torch.dtype) -> torch.Tensor:
    """einsum of the operands rounded to ``cd``, accumulated in f32."""
    return torch.einsum(eq, *(x.to(cd).float() for x in xs))


def _intra_chunk(q, k, v, lw, u, inclusive: bool):
    """Exact pairwise intra-chunk term. q,k,lw: [..., L, N]; v: [..., L, P].
    Returns (y, the within-chunk cumulative log decay)."""
    cw = torch.cumsum(lw, dim=-2)
    e = cw[..., :, None, :] - cw[..., None, :, :]        # [..., L, L, N]
    if not inclusive:
        e = e - lw[..., :, None, :]
    e = torch.clamp(e, max=0.0)
    a = torch.einsum("...tn,...tsn,...sn->...ts", q, torch.exp(e), k)
    n = q.shape[-2]
    rows = torch.arange(n, device=q.device)[:, None]
    cols = torch.arange(n, device=q.device)[None, :]
    keep = (rows >= cols) if inclusive else (rows > cols)
    a = torch.where(keep, a, 0.0)
    y = torch.einsum("...ts,...sp->...tp", a, v)
    if u is not None and not inclusive:
        c = torch.sum(q * u[..., None, :] * k, dim=-1, keepdim=True)
        y = y + c * v
    return y, cw


def _intra_chunk_tiled(q, k, v, lw, u, inclusive: bool, subtile: int = 16,
                       compute_dtype=None):
    """Tile-pair intra-chunk term (the kernel's factorization, vectorized):
    exact pairs only inside the [T, T] diagonal tiles (T = ``subtile``),
    every other pair through boundary-factorized products with exponents
    <= 0. ``compute_dtype`` is the products' operand type (f32
    accumulation). Same arguments and result as :func:`_intra_chunk`."""
    n_l, p = q.shape[-2], v.shape[-1]
    t = subtile
    nt = n_l // t
    cw = torch.cumsum(lw, dim=-2)
    cd = compute_dtype or q.dtype

    def tiles(x):
        return x.reshape(*x.shape[:-2], nt, t, x.shape[-1])

    qt, kt, vt, lwt, cwt = map(tiles, (q, k, v, lw, cw))
    e = cwt[..., :, None, :] - cwt[..., None, :, :]      # [..., nt, T, T, N]
    if not inclusive:
        e = e - lwt[..., :, None, :]
    e = torch.clamp(e, max=0.0)
    a = _mm("...tn,...tsn,...sn->...ts", qt, torch.exp(e), kt, cd=cd)
    rows = torch.arange(t, device=q.device)[:, None]
    cols = torch.arange(t, device=q.device)[None, :]
    a = torch.where((rows >= cols) if inclusive else (rows > cols), a, 0.0)
    y = _mm("...ts,...sp->...tp", a, vt, cd=cd)          # [..., nt, T, P]
    y = y.reshape(*q.shape[:-2], n_l, p)

    # cross-tile pairs through the boundary before each tile
    parts = [y[..., :t, :]]
    for i in range(1, nt):
        t0 = i * t
        cwb = cw[..., t0 - 1, :]                         # [..., N]
        q_exp = cw[..., t0:t0 + t, :] - cwb[..., None, :]
        if not inclusive:
            q_exp = q_exp - lw[..., t0:t0 + t, :]
        q_i = q[..., t0:t0 + t, :] * torch.exp(q_exp)
        k_pre = k[..., :t0, :] * torch.exp(cwb[..., None, :] - cw[..., :t0, :])
        scores = _mm("...tn,...sn->...ts", q_i, k_pre, cd=cd)
        y_i = _mm("...ts,...sp->...tp", scores, v[..., :t0, :], cd=cd)
        parts.append(y[..., t0:t0 + t, :] + y_i)
    y = torch.cat(parts, dim=-2)

    if u is not None and not inclusive:
        c = torch.sum(q * u[..., None, :] * k, dim=-1, keepdim=True)
        y = y + c * v
    return y, cw


def chunk_scan_xla(q, k, v, log_w, u=None, *, chunk: int = 64,
                   inclusive: bool = True,
                   tiled: bool = False) -> torch.Tensor:
    """The chunked formulation, vectorized within chunks. q,k,log_w:
    [BH,S,N]; v: [BH,S,P]; u: [BH,N] or None. S must be a multiple of
    ``chunk`` (callers pad with log_w = 0, k = v = 0). ``tiled=True`` takes
    the tile-pair intra-chunk term with operands in q's type; otherwise
    every product is f32. Returns [BH,S,P] in q's type."""
    orig_dtype = q.dtype
    q, k, v = (x.float() for x in (q, k, v))
    lw = torch.clamp(log_w.float(), max=0.0)
    bh, s, n = q.shape
    p = v.shape[2]
    if s % chunk:
        raise ValueError(f"S={s} is not a multiple of chunk={chunk}")
    c = s // chunk
    qc = q.reshape(bh, c, chunk, n)
    kc = k.reshape(bh, c, chunk, n)
    vc = v.reshape(bh, c, chunk, p)
    lwc = lw.reshape(bh, c, chunk, n)

    uc = u[:, None, :].float() if u is not None else None
    cd = orig_dtype if tiled else torch.float32
    if tiled:
        y_intra, cw = _intra_chunk_tiled(qc, kc, vc, lwc, uc, inclusive,
                                         compute_dtype=cd)
    else:
        y_intra, cw = _intra_chunk(qc, kc, vc, lwc, uc, inclusive)

    # per-chunk transition h' = diag(D) h + S, composed in chunk order
    d_c = torch.exp(cw[..., -1, :])                                  # [bh,c,n]
    k2 = kc * torch.exp(cw[..., -1:, :] - cw)                         # <= 0
    s_c = _mm("bcln,bclp->bcnp", k2, vc, cd=cd)                      # [bh,c,n,p]
    h = torch.zeros_like(s_c[:, 0])
    h_prev = []
    for i in range(c):
        h_prev.append(h)
        h = d_c[:, i, :, None] * h + s_c[:, i]
    h_prev = torch.stack(h_prev, dim=1)                              # [bh,c,n,p]

    q_decay = cw if inclusive else cw - lwc
    y_inter = _mm("bcln,bcnp->bclp", qc * torch.exp(q_decay), h_prev, cd=cd)
    y = (y_intra + y_inter).reshape(bh, s, p)
    return y.to(orig_dtype)
