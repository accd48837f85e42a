"""The port's CUDA kernels on the card (``cuda`` marker; skip without an
sm_90 card).  Run there with

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

This file imports neither ``jax`` nor ``repro``: the machine with the card
has no JAX.  Each kernel is held against its plain PyTorch version on the
same card tensors: ``imc_mac``, ``imc_mac_dequant``, ``bitplane_mac``,
``bitplane_mac_noisy`` and ``rbl_decode_mac`` bit for bit (including detuned
comparator references and 16-row groups; ``rbl_decode_mac`` also at rows
2-32, M up to 200, operands at byte offsets 1 and 4 holding bytes 0-255,
random references, its C launch plan equal to the Python twin;
``bitplane_mac``'s served case,
rows 8 at 8x8 bits, also under random references and on all-255
operands, which of its kernels ran asserted by counter (the r8 kernel at
M <= 8, the tensor-core one above, up to a training forward's M = 512);
the noisy kernel and its plain version draw one Philox stream, and
the noisy kernel's skip is also held on operands and thresholds chosen
against it: dense and zero operands, thresholds a hair inside and outside a
count's band, mismatch 1.0, rows 16 and 3),
``paged_attn`` at the
bounds of ``tests/test_paged_attn.py`` (f32 5e-6, bf16 1.6e-2 = one output
ulp, int8 1e-2), ``flash_attn`` at those of ``tests/test_flash_attn.py``
(f32 3e-6, bf16 2e-2); for these two, each case asserts which kernel ran (the
split, the context-split (rep 9-16) or the staged paged kernel, the tensor-core
(hd <= 128 and 256) or the CUDA-core flash kernel; for ``imc_mac`` and
``imc_mac_dequant``, the split-K kernel at M <= 16 or the tensor-core one
above, also on N not a multiple of 8, weights at a byte offset, K = 0 and
-128 operands, and after two replays of a CUDA graph that captured one
launch).  Every kernel launch bumps the wrapper's counter exactly once (a
context-split call launches two); wrong dtypes and devices raise.  The ``Fabric``
facade's word logic, adder and matmul on the card equal the CPU's.
``bitplane_mac_noisy`` reads its seed words from device memory (a captured
launch replays the seed written before the replay), and the ``Engine``
serves a reduced model from CUDA graphs with the eager engine's streams,
a captured decode step replayed equal to the eager one bit for bit
(``exact`` and noisy ``sim``).  The training path: ``imc_mac`` at a training
forward's M = 2048 (and 2047) on the tensor-core kernel, bit for bit; one
train step's loss, gradients and params on the card against the CPU's plain
path (``exact`` and ``sim``); noisy ``sim``'s remat replaying its seeds
through ``bitplane_mac_noisy``.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.fabric import (Fabric, FabricSpec, NoiseSpec,
                                     fabric_matmul)
from repro_torch.core.logic import WORD_OPS
from repro_torch.core.rbl import rbl_voltage_physics
from repro_torch.kernels.bitplane_mac.ops import (bitplane_kernel,
                                                  bitplane_mac,
                                                  bitplane_mac_noisy,
                                                  bitplane_mac_noisy_torch,
                                                  bitplane_mac_torch,
                                                  bitplane_noisy_kernel,
                                                  physics_thresholds)
from repro_torch.kernels.common import U1_GRID, radius
from repro_torch.kernels.flash_attn.ops import (flash_attention,
                                                flash_attention_torch)
from repro_torch.kernels.imc_mac.ops import (imc_mac, imc_mac_dequant,
                                             imc_mac_dequant_torch,
                                             imc_mac_torch)
from repro_torch.kernels.paged_attn.ops import (paged_attention,
                                                paged_decode_torch)
from repro_torch.kernels.rbl_decode.ops import (rbl_decode_mac,
                                                rbl_decode_mac_torch)
from repro_torch.models.attention import _kv_quant

ATOL = {"f32": 5e-6, "bf16": 1.6e-2, "int8": 1e-2}
FLASH_ATOL = {"f32": 3e-6, "bf16": 2e-2}

pytestmark = pytest.mark.cuda


@pytest.fixture
def hopper():
    if not torch.cuda.is_available() or \
            torch.cuda.get_device_capability() < (9, 0):
        pytest.skip("needs an NVIDIA card with sm_90 (Hopper)")
    return torch.device("cuda")


@pytest.mark.parametrize("m,k,n", [(4, 768, 768), (4, 768, 3072),
                                   (64, 3072, 768), (7, 100, 37),
                                   (33, 1030, 129)])
def test_imc_mac_bit_exact(hopper, m, k, n):
    g = torch.Generator(device=hopper).manual_seed(m * k + n)
    qa = torch.randint(-127, 128, (m, k), generator=g, device=hopper,
                       dtype=torch.int8)
    qw = torch.randint(-127, 128, (k, n), generator=g, device=hopper,
                       dtype=torch.int8)
    before = imc_mac.launches
    out = imc_mac(qa, qw)
    torch.cuda.synchronize()
    assert imc_mac.launches == before + 1
    assert torch.equal(out, imc_mac_torch(qa, qw))


# (m, k, n, byte offset of the weights, fill of a and b or None)
SPLIT_CASES = [(1, 4, 1, 0, None), (3, 100, 31, 0, None),
               (4, 1030, 129, 0, None), (5, 3072, 768, 0, None),
               (9, 0, 3072, 0, None), (16, 1030, 3072, 0, None),
               (17, 1030, 129, 0, None), (16, 768, 768, 0, None),
               (4, 768, 12, 0, None), (4, 0, 768, 0, None),
               (4, 768, 768, 1, None), (4, 768, 768, 4, None),
               (16, 768, 3072, 1, None), (17, 768, 768, 4, None),
               (4, 768, 768, 0, (-128, -128)), (9, 1030, 129, 0, (-128, 127)),
               (17, 768, 31, 0, (-128, -128))]


def _split_operands(dev, m, k, n, off, fill):
    g = torch.Generator(device=dev).manual_seed(m * k + n + off)
    qa = torch.randint(-128, 128, (m, k), generator=g, device=dev,
                       dtype=torch.int8)
    flat = torch.randint(-128, 128, (k * n + off,), generator=g, device=dev,
                         dtype=torch.int8)
    qw = flat[off:].view(k, n)
    if fill is not None:
        qa.fill_(fill[0])
        qw.fill_(fill[1])
    sw = torch.rand((n,), generator=g, device=dev) * 0.099 + 0.001
    return qa, qw, torch.tensor(0.0123, device=dev), sw


def _entry(entry, qa, qw, sa, sw):
    """(wrapper, plain version, their arguments) of one imc_mac entry."""
    if entry == "imc_mac":
        return imc_mac, imc_mac_torch, (qa, qw)
    return imc_mac_dequant, imc_mac_dequant_torch, (qa, qw, sa, sw)


@pytest.mark.parametrize("entry", ["imc_mac", "imc_mac_dequant"])
@pytest.mark.parametrize("m,k,n,off,fill", SPLIT_CASES)
def test_imc_mac_split_and_tiled_kernels(hopper, entry, m, k, n, off, fill):
    qa, qw, sa, sw = _split_operands(hopper, m, k, n, off, fill)
    wrapper, plain, args = _entry(entry, qa, qw, sa, sw)
    before = (wrapper.launches, wrapper.split_launches,
              wrapper.tiled_launches)
    out = wrapper(*args)
    torch.cuda.synchronize()
    rose = (wrapper.launches - before[0], wrapper.split_launches - before[1],
            wrapper.tiled_launches - before[2])
    assert rose == ((1, 1, 0) if m <= 16 else (1, 0, 1))
    assert torch.equal(out, plain(*args))


# the tensor-core kernel (M > 16): every M in {17, 31, 32, 33, 48, 64, 65,
# 130, 512}, K in {0, 4, 140, 1030} and N in {12, 31, 129, 150} appears
MMA_CASES = [(17, 140, 12, 0, None), (31, 1030, 31, 0, None),
             (32, 4, 129, 0, None), (33, 0, 150, 0, None),
             (48, 1030, 129, 1, None), (64, 140, 150, 4, None),
             (65, 4, 31, 1, None), (130, 140, 129, 0, None),
             (512, 1030, 150, 0, None), (64, 768, 768, 1, None),
             (32, 768, 3072, 4, None), (33, 1030, 12, 4, (-128, -128)),
             (64, 140, 31, 0, (127, -127)), (130, 1030, 150, 1, (-128, 127)),
             (48, 4, 129, 4, (-128, 127)), (65, 140, 12, 0, (127, -127))]


@pytest.mark.parametrize("entry", ["imc_mac", "imc_mac_dequant"])
@pytest.mark.parametrize("m,k,n,off,fill", MMA_CASES)
def test_imc_mac_tensor_core_kernel(hopper, entry, m, k, n, off, fill):
    qa, qw, sa, sw = _split_operands(hopper, m, k, n, off, fill)
    wrapper, plain, args = _entry(entry, qa, qw, sa, sw)
    before = (wrapper.launches, wrapper.split_launches,
              wrapper.tiled_launches)
    out = wrapper(*args)
    torch.cuda.synchronize()
    rose = (wrapper.launches - before[0], wrapper.split_launches - before[1],
            wrapper.tiled_launches - before[2])
    assert rose == (1, 0, 1)
    assert torch.equal(out, plain(*args))
    if fill is not None and entry == "imc_mac":
        assert bool((out == fill[0] * fill[1] * k).all())


@pytest.mark.parametrize("entry", ["imc_mac", "imc_mac_dequant"])
@pytest.mark.parametrize("m,k,n", [(4, 768, 768), (16, 3072, 768),
                                   (64, 768, 3072), (32, 768, 3072),
                                   (64, 3072, 768)])
def test_imc_mac_graph_replays_stay_exact(hopper, entry, m, k, n):
    """The split kernel's memset is a node of the graph: a replay must not
    add onto the last one's sums; the tensor-core kernel keeps no state
    between launches."""
    qa, qw, sa, sw = _split_operands(hopper, m, k, n, 0, None)
    wrapper, plain, args = _entry(entry, qa, qw, sa, sw)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        wrapper(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = wrapper(*args)
    graph.replay()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, plain(*args))


def test_imc_mac_int32_case_and_operand_errors(hopper):
    qa = torch.full((8, 2048), 127, dtype=torch.int8, device=hopper)
    qw = torch.full((2048, 8), -127, dtype=torch.int8, device=hopper)
    out = imc_mac(qa, qw).cpu()
    assert bool((out == -127 * 127 * 2048).all())
    with pytest.raises(ValueError, match="one CUDA device"):
        imc_mac(qa, qw.cpu())
    with pytest.raises(TypeError, match="int8"):
        imc_mac(qa.to(torch.int32), qw)


def _ragged(rng, pos, mb, nb, bs):
    tbl = np.full((len(pos), mb), -1, np.int32)
    perm = iter(rng.permutation(nb))
    for i, p in enumerate(pos):
        for j in range(p // bs + 1):
            tbl[i, j] = next(perm)
    return tbl


def _paged_kernel(dtype, rep, hd):
    """The counter the dispatch rules must tick (``takes_split``, then
    ``takes_ctx_split``, else the staged kernel)."""
    if rep <= 8 and hd != 24:
        return "split_launches"
    if 9 <= rep <= 16 and dtype != "f32" and hd % 16 == 0:
        return "ctx_launches"
    return "staged_launches"


@pytest.mark.parametrize("dtype", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("window", [0, 16])
@pytest.mark.parametrize("geom", [(4, 12, 12, 64), (3, 16, 2, 128),
                                  (3, 4, 2, 24), (3, 16, 1, 256),
                                  (3, 24, 2, 256)])
@pytest.mark.parametrize("positions", [None, (0, 15, 16, 127, 3)],
                         ids=["pos5-17-40", "pos0-15-16-127"])
def test_paged_attn_matches_plain(hopper, dtype, window, geom, positions):
    """Demonstrator (MHA, hd 64) and qwen2.5-3b (rep 8, hd 128) geometries
    take the split kernel, hd 24 the staged kernel; recurrentgemma-9b's rep
    16 (and rep 12) at hd 256 the context-split kernel over bf16 and int8
    pools, the staged one over f32; ragged tables with sentinels, the last
    slot inactive.  At pos 0, and at pos 127 under a window of 16, whole
    warps of the split kernel, and whole chunks of the context-split one,
    see no key."""
    B, H, KV, hd = geom
    pos = [5, 17, 40, 0][:B] if positions is None else list(positions)
    B = len(pos)
    bs, mb = 16, 4 if positions is None else 8
    nb = B * mb
    rng = np.random.default_rng(7)
    qdt = torch.float32 if dtype == "f32" else torch.bfloat16
    pdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    q = torch.tensor(rng.standard_normal((B, 1, H, hd)), dtype=qdt,
                     device=hopper)
    k = torch.tensor(rng.standard_normal((nb, bs, KV, hd)), dtype=pdt,
                     device=hopper)
    v = torch.tensor(rng.standard_normal((nb, bs, KV, hd)), dtype=pdt,
                     device=hopper)
    kw = {}
    if dtype == "int8":
        (k, ks), (v, vs) = _kv_quant(k), _kv_quant(v)
        kw = dict(k_scale=ks, v_scale=vs)
    tbl = _ragged(rng, pos, mb, nb, bs)
    tbl[B - 1] = -1
    tbl = torch.tensor(tbl, device=hopper)
    p = torch.tensor(pos, dtype=torch.int32, device=hopper)
    before = paged_attention.launches
    kernel = _paged_kernel(dtype, H // KV, hd)
    counts = {c: getattr(paged_attention, c) for c in (
        "split_launches", "ctx_launches", "merge_launches",
        "staged_launches")}
    out = paged_attention(q, k, v, tbl, p, window=window, **kw)
    torch.cuda.synchronize()
    ctx = kernel == "ctx_launches"  # the kernel and its merge
    assert paged_attention.launches == before + 1 + ctx
    assert {c: getattr(paged_attention, c) - n for c, n in counts.items()} \
        == {c: int(c == kernel or (ctx and c == "merge_launches"))
            for c in counts}
    ref = paged_decode_torch(q, k, v, tbl, p, window=window, **kw)
    assert bool(torch.isfinite(out).all())
    assert bool((out[B - 1] == 0).all()), "an empty table flushes zeros"
    err = (out[:B - 1].float() - ref[:B - 1].float()).abs().max().item()
    if dtype == "int8" and ctx:
        # the context-split kernel keeps the dequantized K, V and P in f32
        # where the plain version rounds them to bf16: within one bf16 ulp
        # at the largest |out| of the plain version (as chip_smoke.py's
        # int8 cases at hd 256) or, farther, within that of a float64
        # witness and no farther from it than the plain version
        tol = max(ATOL[dtype], _bf16_ulp(ref[:B - 1].float().abs().max()
                                         .item()))
        if err > tol:
            exact = _paged_f64(q, k, v, tbl, p, window, **kw)[:B - 1]
            e_k = (out[:B - 1].cpu().double() - exact).abs().max().item()
            e_p = (ref[:B - 1].cpu().double() - exact).abs().max().item()
            assert e_k <= min(tol, e_p), (err, e_k, e_p)
        return
    assert err <= ATOL[dtype], err


def _bf16_ulp(x):
    """The spacing of bf16 values at magnitude ``x``."""
    return 2.0 ** (np.floor(np.log2(x)) - 7) if x > 0 else 0.0


def _paged_f64(q, k, v, tbl, pos, window, k_scale, v_scale):
    """Paged decode in float64 on the CPU, int8 pools dequantized against
    their scales and P kept exact."""
    q, k, v, tbl, pos = (t.cpu() for t in (q, k, v, tbl, pos))
    kd = k.double() * k_scale.cpu().double()[..., None]
    vd = v.double() * v_scale.cpu().double()[..., None]
    b_, _, h, hd = q.shape
    bs, kvh = k.shape[1], k.shape[2]
    out = torch.zeros(q.shape, dtype=torch.float64)
    for b in range(b_):
        p = int(pos[b])
        keys = [t for t in range(p + 1) if int(tbl[b, t // bs]) >= 0
                and (not window or t > p - window)]
        if not keys:
            continue
        blk = [int(tbl[b, t // bs]) for t in keys]
        off = [t % bs for t in keys]
        qg = q[b, 0].double().reshape(kvh, h // kvh, hd)
        sc = (qg @ kd[blk, off].permute(1, 2, 0)) * hd ** -0.5
        out[b, 0] = (sc.softmax(-1) @ vd[blk, off].transpose(0, 1)
                     ).reshape(h, hd)
    return out


def test_paged_attn_rejects_bad_operands(hopper):
    q = torch.zeros((1, 1, 2, 8), dtype=torch.bfloat16, device=hopper)
    k = torch.zeros((2, 4, 2, 8), dtype=torch.float32, device=hopper)
    tbl = torch.zeros((1, 1), dtype=torch.int32, device=hopper)
    p = torch.zeros((1,), dtype=torch.int32, device=hopper)
    with pytest.raises(TypeError):
        paged_attention(q, k, k, tbl, p)  # f32 pools need f32 queries
    with pytest.raises(ValueError, match="plain version"):
        paged_attention(q, k.bfloat16(), k.bfloat16(), tbl, p, impl="torch")
    # the context-split kernel's geometry (rep 16, hd 256): the same checks
    # run before any kernel is chosen, and nothing launches
    q16 = torch.zeros((1, 1, 16, 256), dtype=torch.bfloat16, device=hopper)
    k8 = torch.zeros((2, 4, 1, 256), dtype=torch.int8, device=hopper)
    sc = torch.ones((2, 4, 1), dtype=torch.float16, device=hopper)
    before = paged_attention.launches
    with pytest.raises(ValueError, match="k_scale"):
        paged_attention(q16, k8, k8, tbl, p)  # int8 pools need scales
    with pytest.raises(ValueError, match="f16"):
        paged_attention(q16, k8, k8, tbl, p, k_scale=sc.float(),
                        v_scale=sc.float())
    with pytest.raises(TypeError):  # bf16 pools need bf16 queries
        paged_attention(q16.float(), k8.bfloat16(), k8.bfloat16(), tbl, p)
    with pytest.raises(ValueError, match="one CUDA device"):
        paged_attention(q16, k8, k8, tbl.cpu(), p, k_scale=sc, v_scale=sc)
    assert paged_attention.launches == before


# the served-case kernel (rows 8, 8x8 bits): every M in {1, 3, 4, 5, 9, 64},
# K in {8, 100, 1030, 3072} and N in {1, 31, 129, 768} appears
R8_SHAPES = [(1, 8, 1), (3, 100, 31), (4, 1030, 129), (5, 3072, 768),
             (9, 8, 768), (64, 100, 129), (1, 3072, 31), (3, 1030, 1),
             (4, 8, 31), (5, 100, 1), (9, 1030, 768), (64, 3072, 129)]


# the tensor-core kernel (rows 8, 8x8 bits, M > 8): M in {9, 16, 17, 32,
# 33, 64, 512}, the prefill buckets' projections and the training forward's
MMA_SHAPES = [(17, 768, 129), (32, 768, 3072), (33, 1030, 129),
              (64, 3072, 768), (512, 768, 200), (16, 100, 31), (9, 1030, 40)]


@pytest.mark.parametrize("m,k,n,bits_a,bits_w,rows", [
    (4, 768, 768, 8, 8, 8), (4, 3072, 768, 8, 8, 8), (64, 768, 3072, 8, 8, 8),
    (33, 1030, 129, 8, 8, 8), (16, 768, 768, 4, 8, 8), (5, 40, 12, 6, 6, 8),
    (4, 768, 768, 8, 8, 16), (7, 100, 37, 3, 5, 16)] +
    [(m, k, n, 8, 8, 8) for m, k, n in R8_SHAPES + MMA_SHAPES])
def test_bitplane_mac_bit_exact(hopper, m, k, n, bits_a, bits_w, rows):
    g = torch.Generator(device=hopper).manual_seed(m * k + n + rows)
    ua = torch.randint(0, 1 << bits_a, (m, k), generator=g, device=hopper,
                       dtype=torch.int32)
    uw = torch.randint(0, 1 << bits_w, (k, n), generator=g, device=hopper,
                       dtype=torch.int32)
    before = bitplane_mac.launches
    before_mma = bitplane_mac.mma_launches
    out = bitplane_mac(ua, uw, bits_a=bits_a, bits_w=bits_w, rows=rows)
    torch.cuda.synchronize()
    assert bitplane_mac.launches == before + 1
    # M = 4 (decode) keeps the r8 kernel; M > 8 of the served case takes
    # the tensor-core one
    tc = bitplane_kernel(m, bits_a, bits_w, rows) == "bitplane_mac_mma_kernel"
    assert tc == (rows == 8 and bits_a == bits_w == 8 and m > 8)
    assert bitplane_mac.mma_launches == before_mma + int(tc)
    assert torch.equal(out, bitplane_mac_torch(ua, uw, bits_a=bits_a,
                                               bits_w=bits_w, rows=rows))
    assert torch.equal(out, (ua.double() @ uw.double()).to(torch.int32))


@pytest.mark.parametrize("m,k,n,rows", [(8, 16, 8, 8), (5, 20, 7, 8),
                                        (4, 768, 768, 8), (6, 50, 9, 16)])
def test_bitplane_mac_detuned_thresholds(hopper, m, k, n, rows):
    """Detuned references corrupt the decode in the kernel exactly as in
    the plain version: the thresholds are live data."""
    good = physics_thresholds(rows, hopper)
    detuned = torch.cat([torch.tensor([1.9], device=hopper), good[:-1]])
    g = torch.Generator(device=hopper).manual_seed(m + k + n)
    ua = torch.randint(0, 4, (m, k), generator=g, device=hopper,
                       dtype=torch.int32)
    uw = torch.randint(0, 4, (k, n), generator=g, device=hopper,
                       dtype=torch.int32)
    bad = bitplane_mac(ua, uw, detuned, bits_a=2, bits_w=2, rows=rows)
    torch.cuda.synchronize()
    assert torch.equal(bad, bitplane_mac_torch(ua, uw, detuned, bits_a=2,
                                               bits_w=2, rows=rows))
    assert not torch.equal(bad, bitplane_mac(ua, uw, good, bits_a=2,
                                             bits_w=2, rows=rows))


@pytest.mark.parametrize("m,k,n", [(4, 1030, 129), (9, 3072, 31),
                                   (1, 8, 1), (17, 1030, 129),
                                   (512, 768, 200)])
def test_bitplane_mac_all_255(hopper, m, k, n):
    """Every count is 8: the decode's ninth table entry, every group."""
    ua = torch.full((m, k), 255, device=hopper, dtype=torch.int32)
    uw = torch.full((k, n), 255, device=hopper, dtype=torch.int32)
    before = bitplane_mac.launches
    out = bitplane_mac(ua, uw)
    torch.cuda.synchronize()
    assert bitplane_mac.launches == before + 1
    assert torch.equal(out, bitplane_mac_torch(ua, uw))
    assert torch.equal(out, torch.full_like(out, 255 * 255 * k))


@pytest.mark.parametrize("thr_kind", ["detuned", "random"])
@pytest.mark.parametrize("m,k,n", [(3, 100, 31), (4, 1030, 129),
                                   (4, 768, 768), (9, 8, 1)] + MMA_SHAPES)
def test_bitplane_mac_8x8_live_thresholds(hopper, m, k, n, thr_kind):
    """The served-case kernel decodes detuned and random references as the
    plain version does (its padded bytes weigh nothing)."""
    good = physics_thresholds(8, hopper)
    g = torch.Generator(device=hopper).manual_seed(m + k + n)
    if thr_kind == "detuned":
        thr = torch.cat([torch.tensor([1.9], device=hopper), good[:-1]])
    else:  # uniform between V(8) and V(0), descending
        v0, v8 = rbl_voltage_physics(torch.tensor([0.0, 8.0]),
                                     rows=8).tolist()
        thr = torch.sort(torch.rand(8, generator=g, device=hopper)
                         * (v0 - v8) + v8, descending=True).values
    ua = torch.randint(0, 256, (m, k), generator=g, device=hopper,
                       dtype=torch.int32)
    uw = torch.randint(0, 256, (k, n), generator=g, device=hopper,
                       dtype=torch.int32)
    before = bitplane_mac.launches
    out = bitplane_mac(ua, uw, thr)
    torch.cuda.synchronize()
    assert bitplane_mac.launches == before + 1
    assert torch.equal(out, bitplane_mac_torch(ua, uw, thr))
    assert not torch.equal(out, bitplane_mac(ua, uw, good))


def test_bitplane_mac_batch_dims_and_operand_errors(hopper):
    ua = torch.randint(0, 16, (2, 3, 40), device=hopper, dtype=torch.int32)
    uw = torch.randint(0, 16, (40, 6), device=hopper, dtype=torch.int32)
    out = bitplane_mac(ua, uw, bits_a=4, bits_w=4)
    assert out.shape == (2, 3, 6) and out.dtype == torch.int32
    assert torch.equal(out.reshape(6, 6), (ua.reshape(6, 40).double()
                                           @ uw.double()).to(torch.int32))
    with pytest.raises(ValueError, match="one CUDA device"):
        bitplane_mac(ua, uw.cpu(), bits_a=4, bits_w=4)
    with pytest.raises(ValueError, match="one CUDA device"):
        bitplane_mac(ua, uw, physics_thresholds(8, "cpu"), bits_a=4, bits_w=4)
    with pytest.raises(TypeError, match="integers"):
        bitplane_mac(ua.float(), uw, bits_a=4, bits_w=4)
    with pytest.raises(ValueError, match="rows"):
        bitplane_mac(ua, uw, bits_a=4, bits_w=4, rows=64)


def test_sim_fabric_on_the_card_equals_exact(hopper):
    """Noise-free sim through the kernel decodes every count to itself."""
    g = torch.Generator(device=hopper).manual_seed(9)
    x = torch.randn((3, 5, 768), generator=g, device=hopper).bfloat16()
    w = torch.randn((768, 256), generator=g, device=hopper) * 0.05
    sim = fabric_matmul(x, w, FabricSpec(mode="sim"))
    assert torch.equal(sim, fabric_matmul(x, w, FabricSpec(mode="exact")))
    with pytest.raises(ValueError, match="plain version"):
        fabric_matmul(x, w, FabricSpec(mode="sim", backend="torch"))


NOISE = {"both": dict(mismatch_sigma=0.3, comparator_offset_sigma=0.03),
         "mismatch": dict(mismatch_sigma=0.05),
         "comparator": dict(comparator_offset_sigma=0.03)}


@pytest.mark.parametrize("noise", list(NOISE))
@pytest.mark.parametrize("m,k,n,bits_a,bits_w,rows", [
    (4, 768, 768, 8, 8, 8), (33, 1030, 129, 8, 8, 8), (16, 768, 96, 4, 8, 8),
    (4, 100, 40, 8, 8, 16)])
def test_bitplane_mac_noisy_bit_exact(hopper, noise, m, k, n, bits_a, bits_w,
                                      rows):
    g = torch.Generator(device=hopper).manual_seed(m + k + n + rows)
    ua = torch.randint(0, 1 << bits_a, (m, k), generator=g, device=hopper,
                       dtype=torch.int32)
    uw = torch.randint(0, 1 << bits_w, (k, n), generator=g, device=hopper,
                       dtype=torch.int32)
    kw = dict(bits_a=bits_a, bits_w=bits_w, rows=rows, **NOISE[noise])
    before = bitplane_mac_noisy.launches
    before_mma = bitplane_mac_noisy.mma_launches
    out = bitplane_mac_noisy(ua, uw, 11, **kw)
    torch.cuda.synchronize()
    assert bitplane_mac_noisy.launches == before + 1
    tc = bitplane_noisy_kernel(m, bits_a, bits_w, rows) == \
        "bitplane_mac_noisy_mma_kernel"
    assert bitplane_mac_noisy.mma_launches == before_mma + int(tc)
    assert torch.equal(out, bitplane_mac_noisy_torch(ua, uw, 11, **kw))
    assert torch.equal(out, bitplane_mac_noisy(ua, uw, 11, **kw))


@pytest.mark.parametrize("noise", list(NOISE) + ["mismatch 0.3"])
@pytest.mark.parametrize("m,k,n,thr_kind,fill", [
    (41, 768, 768, "calibrated", None), (47, 768, 256, "calibrated", None),
    (65, 1030, 129, "calibrated", None), (100, 300, 200, "detuned", None),
    (64, 768, 768, "detuned", None), (64, 768, 256, "calibrated", 255),
    (41, 300, 72, "detuned", 255), (512, 768, 256, "calibrated", None)])
def test_bitplane_mac_noisy_mma_bit_exact(hopper, noise, m, k, n, thr_kind,
                                          fill):
    """The tensor-core noisy kernel (rows 8, 8 x 8 bits, M >= 9) against
    its plain version, bit for bit, by the launcher's report: ragged M, K
    (a partial group, a partial k-step) and N, calibrated / stress /
    comparator-only sigmas and mismatch 0.3, a detuned thr, dense 255
    operands (every count 8)."""
    g = torch.Generator(device=hopper).manual_seed(m * 7 + k + n)
    if fill is None:
        ua = torch.randint(0, 256, (m, k), generator=g, device=hopper,
                           dtype=torch.int32)
        uw = torch.randint(0, 256, (k, n), generator=g, device=hopper,
                           dtype=torch.int32)
    else:
        ua = torch.full((m, k), fill, device=hopper, dtype=torch.int32)
        uw = torch.full((k, n), fill, device=hopper, dtype=torch.int32)
    good = physics_thresholds(8, hopper)
    thr = good if thr_kind == "calibrated" else torch.cat(
        [torch.tensor([1.9], device=hopper), good[:-1]])
    kw = dict(mismatch_sigma=0.3) if noise == "mismatch 0.3" else NOISE[noise]
    assert bitplane_noisy_kernel(m, 8, 8, 8) == "bitplane_mac_noisy_mma_kernel"
    before = bitplane_mac_noisy.mma_launches
    out = bitplane_mac_noisy(ua, uw, 11, thr, **kw)
    torch.cuda.synchronize()
    assert bitplane_mac_noisy.mma_launches == before + 1
    assert torch.equal(out, bitplane_mac_noisy_torch(ua, uw, 11, thr, **kw))
    assert torch.equal(out, bitplane_mac_noisy(ua, uw, 11, thr, **kw))


def test_bitplane_mac_noisy_seeds_sigma0_and_detuned(hopper):
    g = torch.Generator(device=hopper).manual_seed(12)
    ua = torch.randint(0, 256, (4, 768), generator=g, device=hopper,
                       dtype=torch.int32)
    uw = torch.randint(0, 256, (768, 256), generator=g, device=hopper,
                       dtype=torch.int32)
    stress = NOISE["both"]
    assert not torch.equal(bitplane_mac_noisy(ua, uw, 1, **stress),
                           bitplane_mac_noisy(ua, uw, 2, **stress))
    clean = bitplane_mac(ua, uw)
    assert torch.equal(bitplane_mac_noisy(ua, uw, 3, mismatch_sigma=0.0,
                                          comparator_offset_sigma=0.0), clean)
    assert torch.equal(bitplane_mac_noisy(ua, uw, 3), clean)
    good = physics_thresholds(8, hopper)
    detuned = torch.cat([torch.tensor([1.9], device=hopper), good[:-1]])
    bad = bitplane_mac_noisy(ua % 4, uw % 4, 4, detuned, bits_a=2, bits_w=2,
                             mismatch_sigma=0.05)
    assert torch.equal(bad, bitplane_mac_noisy_torch(
        ua % 4, uw % 4, 4, detuned, bits_a=2, bits_w=2, mismatch_sigma=0.05))
    with pytest.raises(ValueError, match="one CUDA device"):
        bitplane_mac_noisy(ua, uw.cpu(), 0, **stress)


def _hair(rows, k, reach_v, f, dev):
    """Physics thresholds with the two nearest count k's voltage moved to
    V(k) -+ f x ``reach_v`` volts: a hair inside (f < 1) or outside (f > 1)
    the reach of a draw."""
    thr = physics_thresholds(rows, "cpu").clone()
    v = rbl_voltage_physics(torch.tensor(float(k)), rows=rows)
    thr[k - 1], thr[k] = v + f * reach_v, v - f * reach_v
    return thr.to(dev)


def _mismatch_hair(rows, k, ms, f, dev):
    """Thresholds at V(k -+ f x reach), reach = ms sqrt(k) Z_MAX counts:
    the edges of count k's mismatch band."""
    reach = ms * k ** 0.5 * float(radius(U1_GRID - 1))
    thr = physics_thresholds(rows, "cpu").clone()
    thr[k - 1], thr[k] = rbl_voltage_physics(
        torch.tensor([k - f * reach, k + f * reach]), rows=rows)
    return thr.to(dev)


CAL = dict(mismatch_sigma=0.05)


@pytest.mark.parametrize("case,m,k,n,rows,noise,fill,hair", [
    ("dense", 4, 768, 768, 8, CAL, 255, None),
    ("dense", 4, 768, 768, 8, NOISE["both"], 255, None),
    ("dense", 4, 768, 768, 8, dict(mismatch_sigma=0.3), 255, None),
    ("dense", 4, 768, 256, 16, CAL, 255, None),
    ("dense", 5, 300, 200, 3, NOISE["both"], 255, None),
    ("zero", 4, 768, 768, 8, CAL, 0, None),
    ("zero", 4, 768, 768, 8, NOISE["both"], 0, None),
    ("mismatch 1.0", 4, 768, 768, 8, dict(mismatch_sigma=1.0), None, None),
    ("mismatch 1.0 + offset", 9, 768, 256, 8,
     dict(mismatch_sigma=1.0, comparator_offset_sigma=0.03), None, None),
    ("rows 16", 16, 768, 256, 16, CAL, None, None),
    ("rows 16", 4, 768, 256, 16, NOISE["both"], None, None),
    ("rows 3", 4, 300, 200, 3, CAL, None, None),
    ("rows 3", 7, 300, 200, 3, NOISE["both"], None, None),
    ("hair inside count 3", 4, 768, 768, 8, CAL, None, ("m", 3, 0.999)),
    ("hair outside count 3", 4, 768, 768, 8, CAL, None, ("m", 3, 1.001)),
    ("hair inside count 6", 4, 768, 768, 8, CAL, None, ("m", 6, 0.999)),
    ("hair outside count 6", 4, 768, 768, 8, CAL, None, ("m", 6, 1.001)),
    ("offset hair inside count 3", 4, 768, 768, 8, NOISE["comparator"],
     None, ("c", 3, 0.999)),
    ("offset hair outside count 3", 4, 768, 768, 8, NOISE["comparator"],
     None, ("c", 3, 1.001))])
def test_bitplane_mac_noisy_skip_adversarial(hopper, case, m, k, n, rows,
                                             noise, fill, hair):
    """Operands and thresholds chosen against the kernel's skip: no element
    free (dense), all free (zero), thresholds a hair inside and outside a
    count's band, mismatch 1.0, rows 16 and 3."""
    g = torch.Generator(device=hopper).manual_seed(m + k + n + rows)
    if fill is None:
        ua = torch.randint(0, 256, (m, k), generator=g, device=hopper,
                           dtype=torch.int32)
        uw = torch.randint(0, 256, (k, n), generator=g, device=hopper,
                           dtype=torch.int32)
    else:
        ua = torch.full((m, k), fill, device=hopper, dtype=torch.int32)
        uw = torch.full((k, n), fill, device=hopper, dtype=torch.int32)
    thr = None
    if hair is not None:
        kind, count, f = hair
        thr = _mismatch_hair(rows, count, 0.05, f, hopper) if kind == "m" \
            else _hair(rows, count, 0.03 * float(radius(U1_GRID - 1)), f,
                       hopper)
    kw = dict(rows=rows, **noise)
    before = bitplane_mac_noisy.launches
    out = bitplane_mac_noisy(ua, uw, 11, thr, **kw)
    torch.cuda.synchronize()
    assert bitplane_mac_noisy.launches == before + 1
    assert torch.equal(out, bitplane_mac_noisy_torch(ua, uw, 11, thr, **kw))


def test_noisy_sim_fabric_on_the_card(hopper):
    g = torch.Generator(device=hopper).manual_seed(13)
    x = torch.randn((4, 768), generator=g, device=hopper).bfloat16()
    w = torch.randn((768, 256), generator=g, device=hopper) * 0.05
    spec = FabricSpec(mode="sim", noise=NoiseSpec(0.3, 0.03))
    a = fabric_matmul(x, w, spec, seed=5)
    assert torch.equal(a, fabric_matmul(x, w, spec, seed=5))
    assert not torch.equal(a, fabric_matmul(x, w, spec, seed=6))
    assert torch.equal(fabric_matmul(x, w, spec.replace(
        noise=NoiseSpec(0.0, 0.0)), seed=5), fabric_matmul(
        x, w, FabricSpec(mode="sim")))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("window", [0, 16])
@pytest.mark.parametrize("geom", [(1, 12, 12, 64), (2, 16, 2, 128),
                                  (1, 4, 2, 32), (1, 4, 2, 24),
                                  (1, 16, 8, 256), (1, 16, 1, 256)])
@pytest.mark.parametrize("s", [16, 40, 64, 130, 1, 15, 17, 100])
def test_flash_attn_matches_plain(hopper, dtype, window, geom, s):
    """bf16 at hd 32, 64, 128 and 256 (gemma3-12b's rep 2,
    recurrentgemma-9b's rep 16: two warps a 16-row group) takes the
    tensor-core kernel; f32, and bf16 at hd 24, the CUDA-core kernel."""
    B, H, KV, hd = geom
    dt = torch.float32 if dtype == "f32" else torch.bfloat16
    g = torch.Generator(device=hopper).manual_seed(s + window + H)
    q, k, v = (torch.randn((B, s, h, hd), generator=g, device=hopper).to(dt)
               for h in (H, KV, KV))
    before = flash_attention.launches
    tc, simt = flash_attention.tc_launches, flash_attention.simt_launches
    out = flash_attention(q, k, v, window=window)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    on_tc = dtype == "bf16" and hd != 24
    assert flash_attention.tc_launches == tc + on_tc
    assert flash_attention.simt_launches == simt + (not on_tc)
    assert out.dtype == dt and out.shape == q.shape
    ref = flash_attention_torch(q, k, v, window=window)
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= FLASH_ATOL[dtype], err


def test_flash_attn_rejects_bad_operands(hopper):
    q = torch.zeros((1, 8, 4, 16), dtype=torch.bfloat16, device=hopper)
    k = torch.zeros((1, 8, 2, 16), dtype=torch.bfloat16, device=hopper)
    with pytest.raises(TypeError):
        flash_attention(q, k.float(), k.float())
    with pytest.raises(TypeError):
        flash_attention(q.half(), k.half(), k.half())
    with pytest.raises(ValueError, match="CUDA device"):
        flash_attention(q, k.cpu(), k.cpu())
    with pytest.raises(ValueError, match="does not fit"):
        flash_attention(q, k[:, :4], k[:, :4])


@pytest.mark.parametrize("m,k,n", [(4, 768, 768), (16, 768, 3072),
                                   (64, 3072, 768), (130, 140, 150),
                                   (8, 2048, 8)])
def test_imc_mac_dequant_bit_exact(hopper, m, k, n):
    g = torch.Generator(device=hopper).manual_seed(m + k + n)
    qa = torch.randint(-127, 128, (m, k), generator=g, device=hopper,
                       dtype=torch.int8)
    qw = torch.randint(-127, 128, (k, n), generator=g, device=hopper,
                       dtype=torch.int8)
    if k == 2048:  # deep K at +-127: |acc| = 3.3e7 > 2^24
        qa.fill_(127)
        qw.fill_(-127)
    sa = torch.tensor(0.0123, device=hopper)
    sw = torch.rand((n,), generator=g, device=hopper) * 0.099 + 0.001
    before = imc_mac_dequant.launches
    out = imc_mac_dequant(qa, qw, sa, sw)
    torch.cuda.synchronize()
    assert imc_mac_dequant.launches == before + 1
    assert out.dtype == torch.float32
    assert torch.equal(out, imc_mac_dequant_torch(qa, qw, sa, sw))


def test_imc_mac_dequant_operand_errors(hopper):
    qa = torch.ones((4, 32), dtype=torch.int8, device=hopper)
    qw = torch.ones((32, 8), dtype=torch.int8, device=hopper)
    sa = torch.tensor(0.5, device=hopper)
    sw = torch.ones((8,), device=hopper)
    out = imc_mac_dequant(qa.reshape(2, 2, 32), qw, sa.reshape(1, 1), sw)
    assert out.shape == (2, 2, 8) and bool((out == 16.0).all())
    with pytest.raises(ValueError, match="one CUDA device"):
        imc_mac_dequant(qa, qw, sa.cpu(), sw)
    with pytest.raises(ValueError, match="one CUDA device"):
        imc_mac_dequant(qa, qw, 0.5, sw)
    with pytest.raises(TypeError, match="int8"):
        imc_mac_dequant(qa.to(torch.int32), qw, sa, sw)
    with pytest.raises(ValueError, match="float32"):
        imc_mac_dequant(qa, qw, sa.double(), sw)
    with pytest.raises(ValueError, match="float32"):
        imc_mac_dequant(qa, qw, sa, sw[:4])


@pytest.mark.parametrize("m,k,n,rows", [
    (4, 768, 768, 8), (4, 3072, 768, 8), (64, 768, 3072, 8), (50, 70, 30, 8),
    (5, 3, 7, 8), (24, 160, 8, 16), (64, 768, 768, 16), (7, 100, 37, 32)])
def test_rbl_decode_mac_bit_exact(hopper, m, k, n, rows):
    g = torch.Generator(device=hopper).manual_seed(m * k + n + rows)
    a = torch.randint(0, 2, (m, k), generator=g, device=hopper,
                      dtype=torch.int8)
    w = torch.randint(0, 2, (k, n), generator=g, device=hopper,
                      dtype=torch.int8)
    before = rbl_decode_mac.launches
    out = rbl_decode_mac(a, w, rows=rows)
    torch.cuda.synchronize()
    assert rbl_decode_mac.launches == before + 1
    assert torch.equal(out, rbl_decode_mac_torch(a, w, rows=rows))
    assert torch.equal(out, (a.double() @ w.double()).to(torch.int32))
    good = physics_thresholds(rows, hopper)
    detuned = torch.cat([torch.tensor([1.9], device=hopper), good[:-1]])
    bad = rbl_decode_mac(a, w, detuned, rows=rows)
    assert torch.equal(bad, rbl_decode_mac_torch(a, w, detuned, rows=rows))
    assert not torch.equal(bad, out)


# every rows in {2, 3, 7, 8, 9, 16, 31, 32}, M in {1, 4, 5, 16, 17, 64, 200},
# N in {1, 31, 129, 3072} and K in {3, 8, 100, 1030, 3072} appears, with
# operands as views at byte offsets 1 and 4 of larger buffers
@pytest.mark.parametrize("m,k,n,rows,offsets", [
    (1, 3, 1, 2, (0, 0)), (4, 8, 31, 3, (1, 4)), (5, 100, 129, 7, (4, 1)),
    (16, 1030, 3072, 8, (0, 0)), (17, 3072, 1, 9, (1, 1)),
    (64, 3, 31, 16, (4, 4)), (200, 8, 129, 31, (0, 1)),
    (1, 100, 3072, 32, (1, 0)), (4, 1030, 1, 2, (0, 4)),
    (5, 3072, 31, 3, (4, 0)), (17, 8, 3072, 8, (1, 4)),
    (200, 1030, 31, 16, (1, 1)), (4, 3072, 768, 32, (4, 1)),
    (64, 768, 3072, 8, (1, 4))])
def test_rbl_decode_mac_edges(hopper, m, k, n, rows, offsets):
    """Bytes 0-255 (the kernel counts bit 0; the plain version gets x & 1),
    calibrated, detuned and random references, one launch per call, and the
    C launch plan equal to its Python twin."""
    from repro_torch.kernels.rbl_decode.ops import (compiled_plan,
                                                    rbl_decode_mac_plan)

    assert compiled_plan(m, n, k, rows) == rbl_decode_mac_plan(m, n, k, rows)
    g = torch.Generator(device=hopper).manual_seed(m * k + n + 7 * rows)
    oa, ow = offsets
    fa, fw = (torch.randint(0, 256, (size + off,), generator=g, device=hopper,
                            dtype=torch.int32).to(torch.uint8)
              for size, off in ((m * k, oa), (k * n, ow)))
    a, w = fa[oa:].view(m, k), fw[ow:].view(k, n)
    good = physics_thresholds(rows, hopper)
    v0, vr = (float(v) for v in rbl_voltage_physics(
        torch.tensor([0.0, float(rows)]), rows=rows))
    rand = torch.rand((rows,), generator=g, device=hopper) * (v0 - vr) + vr
    thrs = {"calibrated": good,
            "detuned": torch.cat([torch.tensor([1.9], device=hopper),
                                  good[:-1]]),
            "random": torch.sort(rand, descending=True).values}
    outs = {}
    for name, thr in thrs.items():
        before = rbl_decode_mac.launches
        outs[name] = rbl_decode_mac(a, w, thr, rows=rows)
        torch.cuda.synchronize()
        assert rbl_decode_mac.launches == before + 1
        assert torch.equal(outs[name],
                           rbl_decode_mac_torch(a & 1, w & 1, thr, rows=rows))
    exact = ((a & 1).double() @ (w & 1).double()).to(torch.int32)
    assert torch.equal(outs["calibrated"], exact)
    assert not torch.equal(outs["detuned"], exact)


def test_rbl_decode_mac_operand_errors(hopper):
    a = torch.randint(0, 2, (2, 3, 40), device=hopper, dtype=torch.uint8)
    w = torch.randint(0, 2, (40, 6), device=hopper, dtype=torch.uint8)
    out = rbl_decode_mac(a, w)
    assert out.shape == (2, 3, 6) and out.dtype == torch.int32
    assert torch.equal(out.reshape(6, 6), (a.reshape(6, 40).double()
                                           @ w.double()).to(torch.int32))
    with pytest.raises(ValueError, match="one CUDA device"):
        rbl_decode_mac(a, w.cpu())
    with pytest.raises(ValueError, match="one CUDA device"):
        rbl_decode_mac(a, w, physics_thresholds(8, "cpu"))
    with pytest.raises(TypeError, match="int8 or uint8"):
        rbl_decode_mac(a.to(torch.int32), w)
    with pytest.raises(ValueError, match="float32"):
        rbl_decode_mac(a, w, physics_thresholds(8, hopper).double())
    with pytest.raises(ValueError, match="rows"):
        rbl_decode_mac(a, w, rows=64)
    before = rbl_decode_mac.launches
    empty = rbl_decode_mac(a[:, :0], w)
    assert empty.shape == (2, 0, 6) and rbl_decode_mac.launches == before


@pytest.mark.parametrize("mode", ["exact", "sim"])
def test_facade_on_the_card_equals_the_cpu(hopper, mode):
    rng = np.random.default_rng(14)
    a = rng.integers(0, 256, size=(64, 33)).astype(np.uint8)
    b = rng.integers(0, 256, size=(64, 33)).astype(np.uint8)
    card = Fabric(FabricSpec(mode=mode), hopper)
    cpu = Fabric(FabricSpec(mode=mode), "cpu")
    for op in WORD_OPS:
        assert torch.equal(card.logic_word(a, b, op).cpu(),
                           cpu.logic_word(a, b, op))
    for x, y in zip(card.add_nbit(a, b), cpu.add_nbit(a, b)):
        assert torch.equal(x.cpu(), y)
    x = rng.normal(size=(4, 768)).astype(np.float32)
    w = (rng.normal(size=(768, 96)) * 0.05).astype(np.float32)
    assert torch.equal(card.matmul(x, w).cpu(), cpu.matmul(x, w))
    assert card.cost(x.shape, w.shape) == cpu.cost(x.shape, w.shape)


def test_bitplane_mac_noisy_reads_its_seed_from_device_memory(hopper):
    """The kernel reads its two seed words through a pointer: a seed-table
    row gives what the integer seed gives, and one captured launch replayed
    after the row is rewritten draws the new seed's stream."""
    from repro_torch.kernels.common import seed_row

    g = torch.Generator(device=hopper).manual_seed(21)
    ua = torch.randint(0, 256, (4, 768), generator=g, device=hopper)
    uw = torch.randint(0, 256, (768, 256), generator=g, device=hopper)
    kw = dict(mismatch_sigma=0.3, comparator_offset_sigma=0.03)
    row = seed_row(5, hopper)
    want5 = bitplane_mac_noisy(ua, uw, 5, **kw)
    assert torch.equal(bitplane_mac_noisy(ua, uw, row, **kw), want5)
    assert torch.equal(bitplane_mac_noisy_torch(ua, uw, row, **kw), want5)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        bitplane_mac_noisy(ua, uw, row, **kw)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = bitplane_mac_noisy(ua, uw, row, **kw)
    for seed in (5, 6, 5):
        row.copy_(seed_row(seed, hopper))
        graph.replay()
        assert torch.equal(out, bitplane_mac_noisy(ua, uw, seed, **kw))
    with pytest.raises(ValueError, match="seed row"):
        bitplane_mac_noisy(ua, uw, row.to(torch.int64), **kw)


def test_bitplane_mac_noisy_mma_graph_reads_its_seed_row(hopper):
    """The tensor-core kernel (a bucket-64 prefill's projection) captured
    once: each replay draws the stream of the words written to its seed row
    before it, as an eager call with that seed does."""
    from repro_torch.kernels.common import seed_row

    g = torch.Generator(device=hopper).manual_seed(22)
    ua = torch.randint(0, 256, (64, 768), generator=g, device=hopper)
    uw = torch.randint(0, 256, (768, 512), generator=g, device=hopper)
    kw = dict(mismatch_sigma=0.3)
    row = seed_row(5, hopper)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        bitplane_mac_noisy(ua, uw, row, **kw)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = bitplane_mac_noisy.mma_launches
    with torch.cuda.graph(graph):
        out = bitplane_mac_noisy(ua, uw, row, **kw)
    assert bitplane_mac_noisy.mma_launches == before + 1
    for seed in (5, 6, 5):
        row.copy_(seed_row(seed, hopper))
        graph.replay()
        want = bitplane_mac_noisy_torch(ua, uw, seed, **kw)
        assert torch.equal(out, want)
        assert torch.equal(out, bitplane_mac_noisy(ua, uw, seed, **kw))


@pytest.mark.parametrize("mode", ["exact", "noisy"])
def test_engine_decode_graph_replays_equal_eager(hopper, mode):
    """The served path through ``Engine`` on the card: a reduced model served
    from CUDA graphs gives the eager engine's streams, and one more captured
    decode step replayed on each server's state equals the eager step bit
    for bit (logits and pools), under two seeds."""
    import dataclasses

    from repro_torch.configs import get_config, reduce_config
    from repro_torch.launch.engine import Engine
    from repro_torch.launch.server import Request, Server
    from repro_torch.models.model import init_params
    from repro_torch.telemetry import Registry

    spec = FabricSpec() if mode == "exact" else FabricSpec(
        mode="sim", noise=NoiseSpec(mismatch_sigma=0.3))
    cfg = dataclasses.replace(reduce_config(get_config("imc-paper-110m")),
                              fabric=spec)
    params = init_params(cfg, torch.Generator(device=hopper).manual_seed(0),
                         hopper)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (7, 16, 20, 5)]
    servers = {}
    for graphs in (True, False):
        eng = Engine(hopper, noise_seed=9, registry=Registry(), graphs=graphs)
        s = servers[graphs] = Server(cfg, params, engine=eng, slots=4,
                                     block_size=8, buckets=(16, 32))
        for p in prompts:
            s.submit(Request(p, max_new_tokens=5))
        s.drain()
    assert servers[True].engine.graphs
    assert [h.tokens for h in servers[True].handles] == \
        [h.tokens for h in servers[False].handles]
    assert servers[True].engine.stats.captures == 5  # 2 buckets x 2 + 1
    for seed in (11, 12):
        out = {}
        for graphs, s in servers.items():
            logits = s.engine.decode_step(cfg)((params, s.cache), {
                "token": np.arange(4, dtype=np.int32)[:, None],
                "block_table": s.alloc.table()}, seed)
            out[graphs] = logits.clone()
        assert torch.equal(out[True], out[False])
    for a, b in zip(servers[True].cache.layers, servers[False].cache.layers):
        for x, y in zip(a, b):
            if x is not None:
                assert torch.equal(x, y)
    assert torch.equal(servers[True].cache.pos, servers[False].cache.pos)
    assert servers[True].engine.stats.captures == 5, "no capture after"


# ------------------------------------------------------------ training path
@pytest.mark.parametrize("m", [2048, 2047])
@pytest.mark.parametrize("k,n", [(768, 768), (768, 3072), (3072, 768)])
def test_imc_mac_training_shapes_bit_exact(hopper, m, k, n):
    """A training forward's projections (batch 4 x seq 512 of the
    demonstrator, and a ragged M) on the tensor-core kernel."""
    g = torch.Generator(device=hopper).manual_seed(m + k + n)
    qa = torch.randint(-128, 128, (m, k), generator=g, device=hopper,
                       dtype=torch.int8)
    qw = torch.randint(-128, 128, (k, n), generator=g, device=hopper,
                       dtype=torch.int8)
    split, tiled = imc_mac.split_launches, imc_mac.tiled_launches
    out = imc_mac(qa, qw)
    torch.cuda.synchronize()
    assert (imc_mac.split_launches, imc_mac.tiled_launches) == \
        (split, tiled + 1)
    assert torch.equal(out, imc_mac_torch(qa, qw))


def _rel_l2(a, b):
    a, b = a.double().cpu(), b.double().cpu()
    return float((a - b).norm() / b.norm())


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("mode", ["exact", "sim"])
def test_train_step_on_the_card_equals_the_cpu(hopper, mode, dtype):
    """Reduced imc-paper-110m, 2 layers, batch 2 x seq 32: loss within 1e-3
    (relative) and every gradient leaf within 2e-2 (relative L2) of the
    CPU's plain path with the model's bf16 params, 1e-3 with the same
    params in float32; one train step's params within 5e-3 (Adam's first
    step moves an element by +-lr by its gradient's sign).  With bf16
    params each device's gradients carry bf16 rounding noise, laid down
    differently by the two devices' libraries (measured 8.0e-3 on an
    H100, the f32 norm scales included); in float32 only the summation
    orders differ."""
    import dataclasses

    from repro_torch.configs import get_config, reduce_config
    from repro_torch.data.pipeline import DataConfig, SyntheticStream
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.model import init_params, loss_and_grads
    from repro_torch.optim.adamw import AdamWConfig, init_adamw
    from repro_torch.tree import tree_leaves, tree_map

    spec = FabricSpec() if mode == "exact" else FabricSpec(mode="sim")
    cfg = dataclasses.replace(reduce_config(get_config("imc-paper-110m"),
                                            n_layers=2), fabric=spec)
    cpu = tree_map(lambda t: t.to(getattr(torch, dtype)),
                   init_params(cfg, device="cpu", seed=0))
    card = tree_map(lambda t: t.to(hopper), cpu)
    nb = SyntheticStream(DataConfig(cfg.vocab_size, 32, 2)).batch(0)
    res = {}
    for where, p in (("card", card), ("cpu", cpu)):
        dev = tree_leaves(p)[0].device
        b = {k: torch.from_numpy(v).to(dev) for k, v in nb.items()}
        res[where] = (loss_and_grads(p, b, cfg),
                      make_train_step(cfg, AdamWConfig(lr=1e-3))(
                          p, init_adamw(p), b))
    ((lc, _, gc), (pc, _, _)), ((lp, _, gp), (pp, _, _)) = \
        res["card"], res["cpu"]
    assert abs(float(lc) - float(lp)) <= 1e-3 * abs(float(lp))
    for x, y in zip(tree_leaves(gc), tree_leaves(gp)):
        assert x.device.type == "cuda" and x.dtype == y.dtype
        assert _rel_l2(x, y) <= (2e-2 if dtype == "bfloat16" else 1e-3)
    for x, y in zip(tree_leaves(pc), tree_leaves(pp)):
        assert _rel_l2(x, y) <= 5e-3


def test_noisy_train_remat_replays_on_the_card(hopper):
    """Noisy sim through ``bitplane_mac_noisy``: the layers recomputed in the
    backward replay their seed-table rows (remat on equals remat off, bit
    for bit); one seed replays, another step's seed differs."""
    import dataclasses

    from repro_torch.configs import get_config, reduce_config
    from repro_torch.data.pipeline import DataConfig, SyntheticStream
    from repro_torch.device import deterministic
    from repro_torch.kernels.bitplane_mac.ops import bitplane_mac_noisy
    from repro_torch.kernels.common import seed_table
    from repro_torch.models.model import init_params, loss_and_grads
    from repro_torch.models.transformer import dense_calls
    from repro_torch.tree import tree_leaves

    cfg = dataclasses.replace(
        reduce_config(get_config("imc-paper-110m"), n_layers=2),
        fabric=FabricSpec(mode="sim", noise=NoiseSpec(mismatch_sigma=0.3)))
    params = init_params(cfg, device=hopper, seed=0)
    b = {k: torch.from_numpy(v).to(hopper) for k, v in SyntheticStream(
        DataConfig(cfg.vocab_size, 32, 2)).batch(0).items()}
    runs = []
    before = bitplane_mac_noisy.launches
    for remat, seed in ((True, 5), (False, 5), (True, 6)):
        table = torch.from_numpy(seed_table(seed, dense_calls(cfg))).to(
            hopper)
        with deterministic():
            runs.append(loss_and_grads(
                params, b, dataclasses.replace(cfg, remat=remat),
                noise_seed=table))
    # remat on: 12 launches forward + 12 recomputed; off: 12
    assert bitplane_mac_noisy.launches - before == 24 + 12 + 24
    (l0, _, g0), (l1, _, g1), (l2, _, _) = runs
    assert torch.equal(l0, l1)
    for x, y in zip(tree_leaves(g0), tree_leaves(g1)):
        assert torch.equal(x, y)
    assert not torch.equal(l0, l2)
