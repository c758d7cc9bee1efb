"""A configuration file read once: the sizes every other part of the
harness uses (weights, counts, the reference), and the port's config built
from them.

A configuration file (``configs/<name>.json``) holds the model as it is
run, under the keys of its public ``config.json`` where it has them:
``hidden_size``, ``num_hidden_layers``, ``num_attention_heads``,
``num_key_value_heads``, ``head_dim``, ``intermediate_size``,
``vocab_size``, ``rope_theta``, ``hidden_act`` (``gelu_pytorch_tanh``: a
biased GELU MLP; ``silu``: SwiGLU), ``use_bias`` (q/k/v and MLP biases),
``torch_dtype``, and for sparse experts ``num_local_experts``,
``num_experts_per_tok``; besides ``norm`` (``layernorm`` with a bias, or
``rmsnorm``), ``norm_eps``, ``capacity_factor`` and ``port_arch``, the
port's config id the sizes replace.
"""

from __future__ import annotations

import dataclasses
from typing import Dict


@dataclasses.dataclass(frozen=True)
class Model:
    port_arch: str
    layers: int
    d: int
    heads: int
    kv_heads: int
    hd: int
    ff: int
    vocab: int
    rope_theta: float
    norm: str
    norm_eps: float
    gelu: bool            # biased GELU MLP; else SwiGLU
    bias: bool            # q/k/v biases (and the GELU MLP's)
    experts: int          # 0: a dense MLP
    top_k: int
    capacity_factor: float
    dtype: str

    @classmethod
    def from_config(cls, c: Dict) -> "Model":
        d, heads = int(c["hidden_size"]), int(c["num_attention_heads"])
        return cls(
            port_arch=c["port_arch"], layers=int(c["num_hidden_layers"]),
            d=d, heads=heads, kv_heads=int(c["num_key_value_heads"]),
            hd=int(c.get("head_dim") or d // heads),
            ff=int(c["intermediate_size"]), vocab=int(c["vocab_size"]),
            rope_theta=float(c["rope_theta"]), norm=c["norm"],
            norm_eps=float(c["norm_eps"]),
            gelu=c["hidden_act"] == "gelu_pytorch_tanh",
            bias=bool(c.get("use_bias", False)),
            experts=int(c.get("num_local_experts", 0)),
            top_k=int(c.get("num_experts_per_tok", 0)),
            capacity_factor=float(c.get("capacity_factor", 1.25)),
            dtype=c["torch_dtype"])

    # -- sizes -------------------------------------------------------------
    @property
    def kv_bytes_per_token(self) -> int:
        """K and V of one token over every layer, in the served type."""
        return self.layers * 2 * self.kv_heads * self.hd * self.itemsize

    @property
    def itemsize(self) -> int:
        return 2 if self.dtype in ("bfloat16", "float16") else 4

    def attn_params(self) -> int:
        """One layer's q/k/v/o projections (biases not counted)."""
        return self.d * self.hd * (2 * self.heads + 2 * self.kv_heads)

    def mlp_params(self, active: bool) -> int:
        """One layer's MLP: a dense one, or the experts a token runs
        through (``active``) or every expert held, plus the router."""
        if not self.experts:
            return self.d * self.ff * (2 if self.gelu else 3)
        n = self.top_k if active else self.experts
        return n * 3 * self.d * self.ff + self.d * self.experts

    def trunk_params(self, active: bool = True) -> int:
        return self.layers * (self.attn_params() + self.mlp_params(active))

    # -- the port's config --------------------------------------------------
    def port_config(self, base):
        """``base`` (the port's ``ArchConfig`` for ``port_arch``) with the
        sizes of this file."""
        moe = dict(n_experts=self.experts, top_k=self.top_k,
                   moe_d_ff=self.ff,
                   capacity_factor=self.capacity_factor) if self.experts \
            else {}
        return base.replace(
            n_layers=self.layers, d_model=self.d, n_heads=self.heads,
            n_kv_heads=self.kv_heads, head_dim=self.hd, d_ff=self.ff,
            vocab=self.vocab, rope_theta=self.rope_theta,
            qkv_bias=self.bias, act="gelu" if self.gelu else "swiglu",
            norm=self.norm, compute_dtype=self.dtype, **moe)
