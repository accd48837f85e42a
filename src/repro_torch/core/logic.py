"""MAC-derived logic: Boolean functions read off the decoded MAC count (port
of ``repro/core/logic.py``).

Paper §III-B..E: with m rows activated, a single MAC evaluation yields
    AND  = (count == m)          NAND = !AND
    OR   = (count > 0)           NOR  = !OR
    XOR  = parity(count)         XNOR = !XOR     (m=2: count==1, as Table II)
    SUM  = XOR, CARRY = AND      (1-bit addition, m=2)
simultaneously, with no additional logic circuitry.  8 columns evaluated in
parallel give bitwise 8-bit operations: :func:`logic_word` runs one packed
word per row-pair activation (each bit position is a column), and
:func:`add_nbit` chains :func:`add_1bit` into a ripple-carry adder — two MAC
evaluations per bit (half-adder pair), the carry read off the count.

Word-level functions take an optional ``decode`` callable (counts -> counts)
so the :class:`~repro_torch.core.fabric.Fabric` facade can route every
column's 2-operand count through the spec's analog decode path.

Packed words: a word of 8 bits or fewer packs into ``uint8``; a wider word
into ``int32`` (up to 31 bits) or ``int64`` (PyTorch's ``uint16`` and
``uint32`` support few operations).  Values equal the reference's, whose
unsigned types are narrower.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

OPS = ("AND", "NAND", "OR", "NOR", "XOR", "XNOR", "SUM", "CARRY")
WORD_OPS = ("AND", "NAND", "OR", "NOR", "XOR", "XNOR")


def logic_from_count(count, m: int = 2) -> Dict[str, torch.Tensor]:
    """All MAC-derived logic outputs for an m-operand evaluation.

    ``count``: integer tensor of decoded MAC counts (any shape).
    Returns a dict of uint8 tensors of the same shape.
    """
    count = torch.as_tensor(count).to(torch.int32)
    and_ = (count == m).to(torch.uint8)
    or_ = (count > 0).to(torch.uint8)
    xor = torch.remainder(count, 2).to(torch.uint8)  # == (count==1) for m=2
    return {
        "AND": and_, "NAND": 1 - and_,
        "OR": or_, "NOR": 1 - or_,
        "XOR": xor, "XNOR": 1 - xor,
        "SUM": xor, "CARRY": and_,
    }


def add_1bit(count) -> Tuple[torch.Tensor, torch.Tensor]:
    """1-bit full-adder outputs (SUM, CARRY) from a 2-row MAC evaluation
    (paper §III-E)."""
    out = logic_from_count(count, m=2)
    return out["SUM"], out["CARRY"]


def truth_table_counts() -> torch.Tensor:
    """MAC counts for the four 2-operand input patterns (Table II rows)."""
    a = torch.tensor([0, 0, 1, 1], dtype=torch.int32)
    b = torch.tensor([0, 1, 0, 1], dtype=torch.int32)
    return a + b  # for 1-bit operands, count = A + B


# ------------------------------------------------------------- word level
def unpack_word(x, bits: int = 8) -> torch.Tensor:
    """Packed uints -> bit planes: (...,) -> (..., bits) uint8, LSB first."""
    x = torch.as_tensor(x).to(torch.int64)
    shifts = torch.arange(bits, dtype=torch.int64, device=x.device)
    return ((x[..., None] >> shifts) & 1).to(torch.uint8)


def word_dtype(bits: int) -> torch.dtype:
    """The packed type of a ``bits``-wide word: uint8, int32 or int64."""
    return (torch.uint8 if bits <= 8 else
            torch.int32 if bits <= 31 else torch.int64)


def pack_word(planes: torch.Tensor, dtype=None) -> torch.Tensor:
    """Bit planes -> packed words: (..., bits) {0,1} -> (...,) ``dtype``
    (default :func:`word_dtype`)."""
    bits = planes.shape[-1]
    weights = 1 << torch.arange(bits, dtype=torch.int64, device=planes.device)
    packed = torch.sum(planes.to(torch.int64) * weights, dim=-1)
    return packed.to(word_dtype(bits) if dtype is None else dtype)


def _word_counts(a, b, bits: int) -> torch.Tensor:
    """Per-column 2-operand MAC counts for packed words (one row pair)."""
    return (unpack_word(a, bits).to(torch.int32)
            + unpack_word(b, bits).to(torch.int32))


def logic_word(a, b, op: str, *, bits: int = 8,
               decode: Optional[Callable] = None) -> torch.Tensor:
    """Bitwise ``op`` over packed ``bits``-wide words (paper §III, Table II).

    Each bit position is one macro column; the whole word evaluates in a
    single 2-row MAC activation.  ``decode`` passes every column's count
    through the (modeled) analog path; the default is the ideal count.
    """
    op = op.upper()
    if op not in WORD_OPS:
        raise ValueError(f"op must be one of {WORD_OPS}, got {op!r}")
    count = _word_counts(a, b, bits)
    if decode is not None:
        count = decode(count)
    return pack_word(logic_from_count(count, m=2)[op])


def add_nbit(a, b, *, bits: int = 8, decode: Optional[Callable] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Ripple-carry addition of packed ``bits``-wide words via MAC adds.

    Two :func:`add_1bit` evaluations per bit (operand bits, then sum +
    carry-in); the stage carries combine with an OR.  Returns
    ``(sum mod 2**bits, carry_out)``, the carry as uint8 — the paper's
    §III-E multi-bit extension of the 1-bit adder.
    """
    dec = decode if decode is not None else (lambda c: c)
    pa = unpack_word(a, bits).to(torch.int32)
    pb = unpack_word(b, bits).to(torch.int32)
    carry = torch.zeros(torch.broadcast_shapes(pa.shape[:-1], pb.shape[:-1]),
                        dtype=torch.uint8, device=pa.device)
    outs = []
    for i in range(bits):
        s1, c1 = add_1bit(dec(pa[..., i] + pb[..., i]))
        s2, c2 = add_1bit(dec(s1.to(torch.int32) + carry.to(torch.int32)))
        outs.append(s2)
        carry = torch.bitwise_or(c1, c2)
    return pack_word(torch.stack(outs, dim=-1)), carry
