"""The skip of ``csrc/bitplane_mac_noisy.cu``: draw only where a draw can
change the decode, on the CPU.

The kernel runs only on the card (``tests/test_torch_cuda.py``); this file
checks, where the CPU tests run, what its bit-exactness rests on:

  * Box-Muller on the 2^-24 grid: the radius r(i) = sqrt(-2 log(1 - u1)) of
    ``kernels/common.py`` is monotone over all 2^24 indices of u1 and
    |cos(2 pi u2)| <= 1 over all 2^24 of u2, so every normal of the stream
    lies within Z_MAX = r(2^24 - 1), the bound the tables use;
  * the physics voltage is monotone in float32 k', so over a band of k' it
    lies between its values at the band's ends;
  * the twin of the kernel's prologue (``ops.noisy_skip_tables``), on rows 8
    and 16, calibrated, detuned, random, unordered (with a NaN) and
    duplicated thresholds, mismatch 0.05, 0.3 and 1.0, comparator offset 0
    and 0.03: every count it marks free decodes to ``dec0[k]`` under
    ``decode_counts_noisy`` with the normals injected at +-Z_MAX and on a
    dense sweep, every u1 index below ``cut[k]`` decodes to ``dec0[k]``
    whatever u2, and no threshold lies within the pad of a free band;
  * mutations of the twin fail those checks, each on a named case: the pad
    set to 0 (caught by the margin check: while V is monotone no decode can
    tell), a cut one grid step too high, the band's ends swapped;
  * the kernel's three tiers emulated in torch ops (noise-free decode from
    the table, Philox only where NEED, the full decode only from cut[k] up;
    with comparator offset, a draw only for the comparators V(k') leaves
    undecided) equal ``bitplane_mac_noisy_torch`` bit for bit.
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from bitplane_lanes import tier3_decode
from repro_torch.core.rbl import rbl_voltage_physics
from repro_torch.kernels.bitplane_mac import ops
from repro_torch.kernels.bitplane_mac.ops import (SKIP_PAD,
                                                  bitplane_mac_noisy_torch,
                                                  noisy_skip_tables,
                                                  physics_thresholds)
from repro_torch.kernels.common import (INV_2_24, U1_GRID, box_muller,
                                        cos_2pi_f32, decode_counts_noisy,
                                        radius, seed_words)

ZMAX = radius(U1_GRID - 1)
SIGMAS = [(0.05, 0.0), (0.3, 0.0), (1.0, 0.0), (0.05, 0.03), (0.3, 0.03),
          (1.0, 0.03)]
THR_KINDS = ["calibrated", "detuned", "random", "unordered", "duplicated"]


def _f32(x):
    return float(torch.tensor(float(x), dtype=torch.float32))


def _thresholds(kind, rows):
    good = physics_thresholds(rows, "cpu")
    rng = np.random.default_rng(rows)
    if kind == "calibrated":
        return good
    if kind == "detuned":
        return torch.cat([torch.tensor([1.9]), good[:-1]])
    v0, vr = rbl_voltage_physics(torch.tensor([0.0, float(rows)]),
                                 rows=rows).tolist()
    if kind == "random":
        t = torch.from_numpy(rng.uniform(vr, v0, rows)).float()
        return torch.sort(t, descending=True).values
    if kind == "unordered":  # a shuffle, one threshold NaN (never fires)
        t = good[torch.from_numpy(rng.permutation(rows))].clone()
        t[rows // 2] = float("nan")
        return t
    if kind == "duplicated":
        return good[torch.arange(rows) // 2 * 2]
    raise ValueError(kind)


def _decode(k, thr, rows, ms, cs, z_m, z_c):
    """decode_counts_noisy of counts ``k`` [S] with mismatch normals z_m [S]
    and comparator normals z_c [rows, S]."""
    return decode_counts_noisy(k.to(torch.float32), thr, rows, z_mismatch=z_m,
                               z_comparator=z_c, mismatch_sigma=ms or None,
                               comparator_offset_sigma=cs or None)


def _sweep(n_random, gen):
    """Mismatch normals: +-Z_MAX, 0 and a dense sweep between."""
    z = torch.linspace(-1.0, 1.0, 2001) * ZMAX
    z = torch.cat([z, torch.stack([ZMAX, -ZMAX, torch.zeros(())]),
                   (torch.rand(n_random, generator=gen) * 2 - 1) * ZMAX])
    return z.to(torch.float32)


def _comparator_patterns(rows, s, gen):
    """Comparator normals [rows, s]: all +Z_MAX, all -Z_MAX, alternating
    both ways, and random in [-Z_MAX, Z_MAX], cycling over the samples."""
    sign = torch.ones(rows)
    alt = torch.where(torch.arange(rows) % 2 == 0, sign, -sign)
    fixed = torch.stack([sign, -sign, alt, -alt], 1) * ZMAX  # [rows, 4]
    rand = (torch.rand(rows, s, generator=gen) * 2 - 1) * ZMAX
    idx = torch.arange(s) % 5
    out = torch.where(idx < 4, fixed[:, idx.clamp(max=3)], rand)
    return out.to(torch.float32)


def check_tables(case, thr, rows, ms, cs, tables, pad=SKIP_PAD):
    """Raise AssertionError naming ``case`` and the count where the tables
    claim more than the decode gives, or where a free band comes within
    ``pad`` of a threshold."""
    dec0, need, cut = tables
    gen = torch.Generator().manual_seed(rows)
    v = rbl_voltage_physics(torch.arange(rows + 1).to(torch.float32),
                            rows=rows)
    assert torch.equal(dec0, (v[:, None] <= thr).sum(-1).to(torch.int32)), \
        f"{case}: dec0 is not the noise-free decode"
    reach = _f32(cs) * ZMAX if cs else torch.zeros(())
    for k in range(rows + 1):
        kk = torch.tensor(float(k))
        if not need[k]:
            # every mismatch and offset within Z_MAX keeps dec0[k]
            z = _sweep(2000, gen)
            s = z.numel()
            z_c = _comparator_patterns(rows, s, gen)
            got = _decode(kk.expand(s), thr, rows, ms, cs, z, z_c)
            bad = got != dec0[k]
            assert not bool(bad.any()), (
                f"{case}: count {k} is marked free but decodes to "
                f"{got[bad][0].item()} != {dec0[k].item()} at z "
                f"{z[bad][0].item()}")
            # the margin: no threshold within pad of the band's voltages
            d = (_f32(ms) * torch.sqrt(kk)) * ZMAX if ms else torch.zeros(())
            band = torch.linspace(0.0, 1.0, 4001) * 2 * d + (kk - d)
            band = torch.cat([band, torch.stack([kk - d, kk + d])])
            vb = rbl_voltage_physics(band, rows=rows)
            lo, hi = float(vb.min()), float(vb.max())
            ok = ((thr - reach) >= hi + pad) | ((thr + reach) < lo - pad) | \
                torch.isnan(thr)
            assert bool(ok.all()), (
                f"{case}: count {k} is marked free but a threshold lies "
                f"within {pad} V of its band [{lo}, {hi}]")
        elif cut is not None and int(cut[k]) > 0:
            # below cut[k], any u2: first the largest index at cos = +-1
            c = int(cut[k])
            top = radius(c - 1)
            u1 = torch.randint(0, c, (500,), generator=gen)
            u2 = torch.randint(0, U1_GRID, (500,), generator=gen)
            z = box_muller(u1.to(torch.float32) * INV_2_24,
                           u2.to(torch.float32) * INV_2_24)
            z = torch.cat([torch.stack([top, -top]), z])
            got = _decode(kk.expand(z.numel()), thr, rows, ms, cs, z, None)
            bad = got != dec0[k]
            assert not bool(bad.any()), (
                f"{case}: count {k}, cut {c}: a u1 index below the cut "
                f"decodes to {got[bad][0].item()} != {dec0[k].item()} at z "
                f"{z[bad][0].item()}")


def test_radius_monotone_and_cos_bounded_on_the_grid():
    idx = torch.arange(U1_GRID)
    r = radius(idx)
    assert bool((r[1:] >= r[:-1]).all())
    assert float(r.max()) == float(r[-1]) == float(ZMAX)
    assert 5.768 < float(ZMAX) < 5.7682
    u = idx.to(torch.float32) * INV_2_24
    assert float(cos_2pi_f32(u).abs().max()) <= 1.0
    # radius is box_muller's r: at cos 1 (u2 = 0) and -1 (u2 = 1/2)
    some = idx[::4099]
    uu = some.to(torch.float32) * INV_2_24
    assert torch.equal(box_muller(uu, torch.zeros_like(uu)), r[some])
    assert torch.equal(box_muller(uu, torch.full_like(uu, 0.5)), -r[some])


@pytest.mark.parametrize("rows", [8, 16])
def test_voltage_monotone_in_float_counts(rows):
    lo, hi = (torch.tensor([x]).view(torch.int32).item() for x in (0.25, 48.0))
    for s in range(lo, hi, 1 << 22):
        k = torch.arange(s, min(s + (1 << 22) + 1, hi + 1),
                         dtype=torch.int32).view(torch.float32)
        v = rbl_voltage_physics(k, rows=rows)
        assert bool((v[1:] <= v[:-1]).all())


@pytest.mark.parametrize("ms,cs", SIGMAS)
@pytest.mark.parametrize("kind", THR_KINDS)
@pytest.mark.parametrize("rows", [8, 16])
def test_skip_tables_keep_every_decode(rows, kind, ms, cs):
    thr = _thresholds(kind, rows)
    tables = noisy_skip_tables(thr, rows, ms, cs or None)
    check_tables(f"rows {rows} {kind} ms {ms} cs {cs}", thr, rows, ms, cs,
                 tables)
    dec0, need, cut = tables
    if cs:
        assert cut is None
    else:
        assert bool((cut[~need] == U1_GRID).all())
        assert bool((cut[need] < U1_GRID).all())


def test_skip_tables_calibrated_rows8():
    """The served case: counts 0-3 free, 4-8 drawn, and from cut[k] up a
    draw is rare (the full decode runs on under 2e-5 of 4..8's draws)."""
    thr = physics_thresholds(8, "cpu")
    dec0, need, cut = noisy_skip_tables(thr, 8, 0.05)
    assert dec0.tolist() == list(range(9))
    assert need.tolist() == [False] * 4 + [True] * 5
    assert bool(((U1_GRID - cut[need]) / U1_GRID < 2e-3).all())
    dec0, need, cut = noisy_skip_tables(thr, 8)
    assert not bool(need.any())  # no sigma: nothing drawn


def test_mutation_pad_zero_fails_the_margin():
    """A threshold half a pad below count 3's band: with the pad the count
    is drawn; with pad 0 the twin frees it and the margin check fails (no
    decode tells while V is monotone)."""
    rows, ms = 8, 0.05
    hi = torch.tensor(3.0) + (_f32(ms) * torch.sqrt(torch.tensor(3.0))) * ZMAX
    thr = physics_thresholds(rows, "cpu").clone()
    thr[3] = rbl_voltage_physics(hi, rows=rows) - SKIP_PAD / 2
    case = "pad hair: rows 8, thr[3] = V(band end of count 3) - pad/2"
    tables = noisy_skip_tables(thr, rows, ms)
    assert bool(tables[1][3])
    check_tables(case, thr, rows, ms, 0.0, tables)
    mutant = noisy_skip_tables(thr, rows, ms, pad=0.0)
    with pytest.raises(AssertionError, match="pad hair.*count 3.*within"):
        check_tables(case, thr, rows, ms, 0.0, mutant)


def test_mutation_cut_one_step_high_fails():
    """At mismatch 0.05 one grid step near cut[4..8] moves the band's end by
    ~1.6e-5 V, far more than the pad, so the index the mutant lets through
    decodes otherwise.  (At 0.3 a step near the cuts is ~1e-8 V: the next
    index still lies within the pad, and no decode tells.)"""
    rows, ms = 8, 0.05
    thr = physics_thresholds(rows, "cpu")
    dec0, need, cut = noisy_skip_tables(thr, rows, ms)
    case = "rows 8 calibrated ms 0.05"
    check_tables(case, thr, rows, ms, 0.0, (dec0, need, cut))
    high = torch.where(need, cut + 1, cut)
    with pytest.raises(AssertionError, match="rows 8 calibrated ms 0.05: "
                                             "count .*below the cut"):
        check_tables(case, thr, rows, ms, 0.0, (dec0, need, high))


def test_mutation_band_ends_swapped_fails(monkeypatch):
    rows, ms = 8, 0.05
    thr = physics_thresholds(rows, "cpu")
    ends = ops._band_ends
    monkeypatch.setattr(ops, "_band_ends",
                        lambda k, rz, m: tuple(reversed(ends(k, rz, m))))
    mutant = noisy_skip_tables(thr, rows, ms)
    with pytest.raises(AssertionError, match="rows 8 calibrated ms 0.05: "
                                             "count 4 is marked free"):
        check_tables("rows 8 calibrated ms 0.05", thr, rows, ms, 0.0, mutant)


# ------------------------------------------------- the three tiers emulated
def emulate(ua, uw, seed, thr, bits_a, bits_w, rows, ms, cs):
    """The kernel's tiers in torch ops: dec0[k] for every element, Philox
    only for the NEED counts; with mismatch alone, the full decode only at a
    u1 index from cut[k] up; with comparator offset, V(k') and a draw only
    for the comparators it leaves undecided.  Returns (out, share of
    elements in tier 3, share that ran the full decode)."""
    dec0, need, cut = noisy_skip_tables(thr, rows, ms or None, cs or None)
    key = seed_words(seed)
    m, kdim = ua.shape
    g = -(-kdim // rows)
    a = F.pad(ua.to(torch.int64), (0, g * rows - kdim)).reshape(m, g, rows)
    w = F.pad(uw.to(torch.int64), (0, 0, 0, g * rows - kdim)).reshape(
        g, rows, -1)
    out = torch.zeros((m, w.shape[-1]), dtype=torch.int64)
    tier3 = full = total = 0
    for p in range(bits_a):
        for q in range(bits_w):
            k = torch.einsum("mgr,grn->gmn", (a >> p) & 1, (w >> q) & 1)
            dec = dec0[k].to(torch.int64)
            sel = need[k]
            gi, mi, ni = sel.nonzero(as_tuple=True)
            got, n_full = tier3_decode(key, ni, mi, gi, p * bits_w + q,
                                       k[sel], thr, rows, ms, cs, dec0, cut)
            full += n_full
            dec[sel] = got
            out += dec.sum(0) << (p + q)
            tier3 += int(sel.sum())
            total += sel.numel()
    return out.to(torch.int32), tier3 / total, full / total


def _hair(rows, ms, k, f):
    thr = physics_thresholds(rows, "cpu").clone()
    reach = ms * k ** 0.5 * float(ZMAX)
    thr[k - 1], thr[k] = rbl_voltage_physics(
        torch.tensor([k - f * reach, k + f * reach]), rows=rows)
    return thr


@pytest.mark.parametrize("m,k,n,bits_a,bits_w,rows,thr,ms,cs,fill", [
    (4, 64, 40, 8, 8, 8, "calibrated", 0.05, 0.0, None),
    (5, 100, 33, 8, 8, 8, "calibrated", 0.3, 0.0, None),
    (4, 60, 20, 8, 8, 8, "calibrated", 1.0, 0.0, None),
    (3, 40, 33, 8, 8, 8, "calibrated", 0.0, 0.03, None),
    (4, 64, 40, 8, 8, 8, "calibrated", 0.3, 0.03, None),
    (9, 70, 31, 4, 3, 16, "calibrated", 0.3, 0.03, None),
    (4, 30, 20, 5, 6, 3, "calibrated", 0.3, 0.03, None),
    (4, 48, 35, 8, 8, 8, "calibrated", 0.05, 0.0, 255),
    (4, 48, 35, 8, 8, 8, "calibrated", 0.3, 0.03, 255),
    (4, 64, 40, 2, 2, 8, "detuned", 0.3, 0.03, None),
    (4, 64, 40, 8, 8, 8, "unordered", 0.3, 0.0, None),
    (4, 64, 40, 8, 8, 8, "hair inside", 0.05, 0.0, None),
    (4, 64, 40, 8, 8, 8, "hair outside", 0.05, 0.0, None)])
def test_three_tiers_equal_the_plain_version(m, k, n, bits_a, bits_w, rows,
                                             thr, ms, cs, fill):
    g = torch.Generator().manual_seed(m * k + n + rows)
    if fill is None:
        ua = torch.randint(0, 1 << bits_a, (m, k), generator=g)
        uw = torch.randint(0, 1 << bits_w, (k, n), generator=g)
    else:
        ua = torch.full((m, k), fill % (1 << bits_a))
        uw = torch.full((k, n), fill % (1 << bits_w))
    if thr.startswith("hair"):
        t = _hair(rows, ms, 3, 0.999 if thr.endswith("inside") else 1.001)
    else:
        t = _thresholds(thr, rows)
    got, tier3, full = emulate(ua, uw, 11, t, bits_a, bits_w, rows, ms, cs)
    plain = bitplane_mac_noisy_torch(ua, uw, 11, t, bits_a=bits_a,
                                     bits_w=bits_w, rows=rows,
                                     mismatch_sigma=ms or None,
                                     comparator_offset_sigma=cs or None)
    assert torch.equal(got, plain)
    if (thr, ms, cs, fill) == ("calibrated", 0.05, 0.0, None):
        assert 0.0 < tier3 < 0.2 and full < 1e-3
