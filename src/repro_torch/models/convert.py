"""Carry parameters across from the JAX reference.

The reference initializes its models randomly (``BaseLM.init``); the two
frameworks draw different bits from one seed, so the parity tests convert
the reference's parameters instead. The input is the JAX parameter pytree
as numpy arrays (``jax.tree.map(np.asarray, params)``), checked against
the port's ``param_specs`` of the same family:

- dense: ``embed``, ``stack.layers.{norm1, mixer.{wq,wk,wv,wo,bq,bk,bv},
  norm2, ffn.{wi,wo}}``, ``final_norm``, ``unembed``;
- ssm (RWKV6): ``embed``, ``ln0``, ``layers.{ln1, tm.*, ln2, cm.*}``
  stacked ``[L, ...]``, ``final_norm``, ``unembed``;
- hybrid (Zamba2): ``embed``, ``stack.mamba_layers.{norm, mixer.*}``
  stacked ``[L, ...]``, ``stack.shared.{norm1, attn.*, norm2, ffn.*}``,
  ``final_norm``, ``unembed``;
- moe (grok-1): the dense tree with ``stack.layers.ffn.{router, w1, w2}``
  (and ``shared.{wi, wo}`` where the config has shared experts) in place
  of the dense FFN;
- moe_mla (deepseek-v2-lite): the moe tree with
  ``stack.layers.mixer.{wq, wdkv, kv_norm, wuk, wuv, wo}``;
- dense with ``act="gelu"`` (starcoder2): ``stack.layers.ffn.{wi, bi, wo,
  bo}`` and LayerNorm ``{w, b}`` under ``norm1``, ``norm2`` and
  ``final_norm``;
- vlm (internvl2): the dense tree and ``vision_proj``;
- encdec (whisper): ``embed``, ``encdec.{enc_layers.{norm1, attn.*,
  norm2, ffn.*}, enc_norm, dec_layers.{norm1, self_attn.*, norm_x,
  cross_attn.*, norm2, ffn.*}, dec_norm, dec_pos}`` (layers stacked
  ``[L, ...]``), ``unembed``.

Layouts are kept, so the port computes on exactly the reference's
tensors. :func:`opt_state_from_jax` carries an optimizer state across
(AdamW's ``{m, v, step}``, Adafactor's ``{v, step}`` with factored
``{vr, vc}`` leaves), and :func:`tree_to_numpy` goes the way back, a port
tree as ``{"a/b/c": numpy}``, so gradients and updated parameters can be
held against the reference's leaf by leaf.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L
from repro_torch.models.registry import build_model


def params_from_jax(np_tree: Dict[str, Any], cfg: ArchConfig,
                    device="cpu") -> Dict[str, Any]:
    """The port's parameters from the reference's (numpy) pytree; raises
    if a leaf is missing, extra, or of another shape than the port's
    spec."""
    specs = build_model(cfg).param_specs()
    want = {path: spec for path, spec in L.tree_leaves(specs)}
    got = {path: leaf for path, leaf in L.tree_leaves(np_tree)}
    if set(want) != set(got):
        missing = sorted(".".join(p) for p in set(want) - set(got))
        extra = sorted(".".join(p) for p in set(got) - set(want))
        raise ValueError(f"parameter trees differ: missing {missing}, "
                         f"extra {extra}")
    out: Dict[str, Any] = {}
    for path, spec in want.items():
        arr = np.asarray(got[path])
        if tuple(arr.shape) != tuple(spec.shape):
            raise ValueError(f"{'.'.join(path)}: shape {arr.shape} != "
                             f"{spec.shape}")
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = torch.tensor(arr, dtype=spec.dtype, device=device)
    return out


def opt_state_from_jax(np_state: Dict[str, Any], params,
                       device="cpu") -> Dict[str, Any]:
    """The port's optimizer state from the reference's (numpy): AdamW's
    ``{"m", "v", "step"}`` or Adafactor's ``{"v", "step"}``, read along
    the port's ``params`` tree (a moment leaf of its parameter's shape,
    or Adafactor's factored ``{"vr", "vc"}`` / ``{"v"}``); raises if a
    shape differs. ``step`` becomes a 0-d int32 tensor."""
    def f32(a, shape, where):
        if tuple(np.shape(a)) != tuple(shape):
            raise ValueError(f"{where}: shape {np.shape(a)} != {shape}")
        return torch.tensor(np.asarray(a), dtype=torch.float32,
                            device=device)

    out: Dict[str, Any] = {"step": torch.tensor(
        np.asarray(np_state["step"]), dtype=torch.int32, device=device)}
    for name in ("m", "v"):
        if name not in np_state:
            continue
        out[name] = {}
        for path, p in L.tree_leaves(params):
            node = np_state[name]
            for k in path:
                node = node[k]
            where = f"{name}.{'.'.join(path)}"
            shape = tuple(p.shape)
            if isinstance(node, dict):          # Adafactor
                want = ({"vr": shape[:-1], "vc": shape[:-2] + shape[-1:]}
                        if len(shape) >= 2 else {"v": shape})
                if set(node) != set(want):
                    raise ValueError(f"{where}: {sorted(node)} != "
                                     f"{sorted(want)}")
                leaf = {k: f32(node[k], want[k], f"{where}.{k}")
                        for k in want}
            else:
                leaf = f32(node, shape, where)
            L._put(out[name], path, leaf)
    return out


def tree_to_numpy(tree) -> Dict[str, np.ndarray]:
    """A port tree as ``{"a/b/c": numpy}`` in the reference's flatten
    order (the checkpointer's leaf keys)."""
    return {"/".join(path): leaf.detach().cpu().numpy()
            if isinstance(leaf, torch.Tensor) else np.asarray(leaf)
            for path, leaf in L.tree_leaves(tree)}
