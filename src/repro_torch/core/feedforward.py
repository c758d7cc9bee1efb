"""The feed-forward stage abstraction: a composable producer/consumer split
(the port of ``repro.core.feedforward``).

A kernel is re-expressed as a *stream program*:

  * a **producer** that, for word index ``i``, names the global-memory reads
    (and only the reads) needed by that word;
  * a **consumer** that folds each word into a carry (all arithmetic, DLCDs,
    and global stores live here);

plus a :class:`~repro_torch.core.pipe.Pipe` describing the FIFO between
them.

Given a :class:`StreamSpec` you can:

  * run it with **reference semantics** (:func:`run_reference`): the single
    work-item program order, one word fully loaded then fully consumed, a
    plain Python loop; this is the correctness oracle of every kernel;
  * **estimate** its baseline/FF/M2C2 timing via ``core.pipeline_model``;
  * hold a kernel of ``repro_torch.kernels`` against it: the CUDA kernels
    specialise the word schedule (a shared-memory ring fed by producer
    warps, ``csrc/ring_pipe.cuh``) rather than interpreting the spec, so
    the spec is the contract they are tested against.

The split is legal only when no word's loads depend on a *later or same*
word's stores through global memory (the paper's MLCD restriction).
:func:`check_no_mlcd` verifies this on a declared read/write footprint.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Sequence, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class StreamSpec:
    """A feed-forward stream program.

    Attributes:
      n_words: trip count of the main loop (pipe words).
      producer: ``f(i, operands) -> word`` gathering word ``i``'s loads from
        the operands. Must be free of stores and of any dependence on the
        consumer carry: the feed-forward restriction, enforced structurally
        (the producer has no access to the carry).
      consumer: ``f(carry, word, i) -> carry`` folding one word.
      init: initial consumer carry.
      finalize: optional ``f(carry) -> out`` epilogue.
    """

    n_words: int
    producer: Callable[[int, Any], Any]
    consumer: Callable[[Any, Any, int], Any]
    init: Any
    finalize: Optional[Callable[[Any], Any]] = None


def run_reference(spec: StreamSpec, operands: Any) -> Any:
    """Oracle: execute the stream program in strict program order, each
    iteration loading its word then consuming it, no overlap (the paper's
    single work-item kernel, Fig. 2a). Every kernel must be close to it."""
    carry = spec.init
    for i in range(spec.n_words):
        carry = spec.consumer(carry, spec.producer(i, operands), i)
    return spec.finalize(carry) if spec.finalize is not None else carry


def run_multistream_reference(spec: StreamSpec, operands: Any, streams: int,
                              combine: Callable[[Sequence[Any]], Any]) -> Any:
    """Oracle for the M2C2 schedule: static parity load balancing.

    Stream ``s`` consumes words ``s, s+streams, s+2*streams, ...`` (the
    paper's static round-robin split), each with its own carry; ``combine``
    merges the per-stream carries. Only valid when the consumer fold is
    reorderable across streams (a commutative-monoid carry), the paper's
    restriction on multi-consumer designs."""
    outs = []
    for words in split_words_static(spec.n_words, streams):
        carry = spec.init
        for i in words:
            carry = spec.consumer(carry, spec.producer(i, operands), i)
        outs.append(carry)
    merged = combine(outs)
    return spec.finalize(merged) if spec.finalize is not None else merged


# ---------------------------------------------------------------------------
# MLCD legality check (paper Section 3, "Limitations")
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Footprint:
    """Declared global-memory footprint of one word, as index ranges.

    ``reads`` / ``writes``: sequences of (buffer_name, lo, hi) half-open
    intervals word ``i`` touches.
    """

    reads: Tuple[Tuple[str, int, int], ...]
    writes: Tuple[Tuple[str, int, int], ...]


def check_no_mlcd(footprints: Sequence[Footprint]) -> Tuple[bool, str]:
    """True MLCD detector over declared footprints.

    A memory loop-carried dependency exists iff some word ``j > i`` *reads*
    a region word ``i`` *writes* (RAW through global memory across words).
    Such programs must not be feed-forward split. WAR/WAW across words are
    harmless because the producer never writes.

    Returns (ok, reason). O(n^2) over words: for spec-sized tests and the
    microbenchmark generator, not production loops.
    """
    for i, fi in enumerate(footprints):
        for name_w, wlo, whi in fi.writes:
            for j in range(i + 1, len(footprints)):
                for name_r, rlo, rhi in footprints[j].reads:
                    if name_w == name_r and max(wlo, rlo) < min(whi, rhi):
                        return False, (
                            f"true MLCD: word {j} reads {name_r}[{rlo}:{rhi}) "
                            f"written by word {i} [{wlo}:{whi})")
    return True, "no true MLCD"


def split_words_static(n_words: int, streams: int) -> Sequence[Sequence[int]]:
    """The paper's static load-balancing: word i -> stream (i % streams)."""
    return [list(range(s, n_words, streams)) for s in range(streams)]


# ---------------------------------------------------------------------------
# Convenience streams (tests, microbenchmarks, chip_smoke.py): the classic
# tiled reduction, and the specs the product and gather kernels are held to
# ---------------------------------------------------------------------------


def reduction_stream(x: torch.Tensor, tile_rows: int,
                     fold: Callable[[torch.Tensor], torch.Tensor] = torch.sum
                     ) -> StreamSpec:
    """Stream a [N, C] tensor by row tiles, folding each tile to a scalar
    sum."""
    n, _ = x.shape
    if n % tile_rows:
        raise ValueError(f"{n} rows are not a multiple of tile_rows="
                         f"{tile_rows}")

    def producer(i, ops):
        return ops[i * tile_rows:(i + 1) * tile_rows]

    def consumer(carry, word, i):
        return carry + fold(word)

    return StreamSpec(
        n_words=n // tile_rows,
        producer=producer,
        consumer=consumer,
        init=torch.zeros((), dtype=x.dtype, device=x.device),
    )


def ktiled_product_spec(m: int, k: int, n: int, tk: int,
                        device="cpu") -> StreamSpec:
    """C = A @ B as a stream over k (operands ``(a, b)``): word i is the
    k-tile ``(A[:, tile], B[tile, :])``; the consumer folds its product
    into an f32 [m, n] carry on ``device``."""
    if k % tk:
        raise ValueError(f"k={k} is not a multiple of the k-tile {tk}")

    def producer(i, ops):
        a, b = ops
        return a[:, i * tk:(i + 1) * tk], b[i * tk:(i + 1) * tk]

    def consumer(carry, word, i):
        a_t, b_t = word
        return carry + a_t.float() @ b_t.float()

    return StreamSpec(n_words=k // tk, producer=producer, consumer=consumer,
                      init=torch.zeros(m, n, dtype=torch.float32,
                                       device=device))


def row_gather_spec(n: int, cols: int, rows: int, dtype=torch.float32,
                    device="cpu") -> StreamSpec:
    """out = table[idx] (operands ``(table, idx)``, ``n`` indices) as a
    stream of ``rows``-row words: word i reads the table rows
    ``idx[i*rows:(i+1)*rows]``; the consumer places them in an [n, cols]
    carry of ``dtype`` on ``device``."""

    def producer(i, ops):
        table, idx = ops
        return table[idx[i * rows:(i + 1) * rows].long()]

    def consumer(carry, word, i):
        carry = carry.clone()
        carry[i * rows:i * rows + word.shape[0]] = word
        return carry

    return StreamSpec(n_words=-(-n // rows), producer=producer,
                      consumer=consumer,
                      init=torch.zeros(n, cols, dtype=dtype, device=device))
