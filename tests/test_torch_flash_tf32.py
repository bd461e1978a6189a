"""The arithmetic of the fp32 flash kernel (``csrc/flash_attention.cu``,
3xTF32 on the tensor cores) emulated in plain PyTorch on the CPU and held
against the JAX package.

The kernel splits each operand of both products as ``x = hi + lo`` with
``hi = tf32(x)`` and ``lo = tf32(x - hi)`` (``cvt.rna.tf32.f32``: 10
mantissa bits kept, round to nearest, ties away from zero), issues
``lo_a hi_b``, ``hi_a lo_b`` and ``hi_a hi_b`` per 8-wide k-step as three
``mma.sync`` m16n8k8 into one f32 accumulator, and runs an f32 online
softmax in base 2 over 32-key tiles; each tile's P V runs into
accumulators of its own and joins O in one rounded FMA.

The emulation models the tensor cores' sums as well as their products
(``mma``): a product of two TF32 numbers is exact, and each ``mma.sync``
adds its k-step's 8 products to the accumulator and truncates the sum to
f32.  Sums rounded to nearest would leave out the error that dominates on
the card: on an H100, ``chip_smoke.py``'s phase 2d read 6.40e-6 per row for
this design at (4, 32, 8, 1024, 128) causal and 1.53e-5 for one that sums
P V into O itself, and the model shows the same gap
(``test_truncating_sums_cost_a_design_that_sums_into_o``).  The k-steps of
Q K^T take the head-dimension columns in the kernel's order.

Held to fp32's bar of 2e-5 per output row against the Pallas kernel
(interpret mode) and ``repro.kernels.ref``; one TF32 pass per product must
miss it.  The kernel itself runs in ``tests/test_torch_cuda.py`` and
``chip_smoke.py``, on the card.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.flash_attention import flash_attention_pallas  # noqa: E402

#: fp32's bar per output row (max |got - want| over that row's max-abs),
#: as tests/test_torch_cuda.py and chip_smoke.py hold the kernel to it
TOL_ROW = 2e-5
TILE = 32               # the kernel's keys per tile
LOG2E = 1.4426950408889634


def tf32(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32`` on f32 values: the low 13 mantissa bits
    rounded away on the int32 view, to nearest, ties away from zero (half
    of the dropped unit added to the magnitude, then the bits cleared)."""
    assert x.dtype == torch.float32
    bits = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    sign = bits & 0x80000000
    mag = ((bits & 0x7FFFFFFF) + 0x1000) & 0x7FFFE000
    out = sign | mag
    return torch.where(out >= 2**31, out - 2**32, out).to(torch.int32) \
        .view(torch.float32)


def split(x: torch.Tensor):
    hi = tf32(x)
    return hi, tf32(x - hi)


def round_to_zero(x: torch.Tensor) -> torch.Tensor:
    """f64 values rounded toward zero to f32."""
    y = x.to(torch.float32)
    return torch.where(y.double().abs() > x.abs(),
                       torch.nextafter(y, torch.zeros_like(y)), y)


def mma(acc, a, b):
    """One ``mma.sync`` k-step: acc (..., M, N) f32 plus a (..., M, 8) @ b
    (..., 8, N) of TF32 values, the products and their sum exact (f64),
    the result truncated to f32."""
    return round_to_zero(acc.double() + a.double() @ b.double())


def qk_steps(hd: int) -> list:
    """The kernel's k-steps of Q K^T over hd padded to 16: within each 16
    columns, slot t of the first k-step is column 4t and slot t + 4 column
    4t + 1, of the second 4t + 2 and 4t + 3."""
    pairs = [[4 * t + c for t in range(4) for c in (0, 1)],
             [4 * t + c for t in range(4) for c in (2, 3)]]
    return [[c0 + c for c in cols] for c0 in range(0, hd, 16)
            for cols in pairs]


def product(acc, a, b, steps, passes):
    """acc + a @ b over the k-steps ``steps`` of the shared axis as the
    kernel issues them: per k-step the two small terms, then hi hi (three
    passes), or hi hi alone (one TF32 pass); a and b are (hi, lo) pairs."""
    (ah, al), (bh, bl) = a, b
    for cols in steps:
        if passes == 3:
            acc = mma(acc, al[..., cols], bh[..., cols, :])
            acc = mma(acc, ah[..., cols], bl[..., cols, :])
        acc = mma(acc, ah[..., cols], bh[..., cols, :])
    return acc


def emulate(q, k, v, scale, causal, passes=3, join="apart"):
    """The kernel's attention: q (B, H, S, hd), k / v (B, K, S, hd) (head h
    reads KV head h // G), hd padded with zeros to 16, 32-key tiles (keys
    past S zeros), the online softmax in base 2 with scale * log2 e folded
    in, masked scores -1e30, the row sum clamped at 1e-30.  ``passes``: 3
    (3xTF32) or 1 (one TF32 pass).  ``join``: "apart" (each tile's P V from
    zero, then O corr + P V in one rounded FMA, the kernel) or "into" (O
    scaled by corr, then P V summed into it)."""
    B, H, S, hd = q.shape
    G = H // k.shape[1]
    padded = -(-hd // 16) * 16

    def pad(x, rows=None):
        out = torch.zeros(x.shape[:2] + (rows or x.shape[2], padded))
        out[:, :, :x.shape[2], :hd] = x
        return out

    def parts(x):
        return split(x) if passes == 3 else (tf32(x), None)

    q = parts(pad(q))
    k = pad(k.repeat_interleave(G, dim=1), S + TILE)
    v = pad(v.repeat_interleave(G, dim=1), S + TILE)
    c = torch.tensor(scale * LOG2E, dtype=torch.float32)
    rows = torch.arange(S)[:, None]
    m = torch.full((B, H, S, 1), -1e30)
    l = torch.zeros((B, H, S, 1))
    o = torch.zeros((B, H, S, padded))
    for k0 in range(0, S, TILE):
        kt = parts(k[:, :, k0:k0 + TILE].transpose(-1, -2).contiguous())
        s = product(torch.zeros((B, H, S, TILE)), q, kt, qk_steps(padded),
                    passes) * c
        cols = torch.arange(k0, k0 + TILE)[None, :]
        masked = (cols >= S) | ((cols > rows) if causal else False)
        s = torch.where(masked, torch.tensor(-1e30), s)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        corr = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        m = m_new
        steps = [list(range(j, j + 8)) for j in range(0, TILE, 8)]
        vt = parts(v[:, :, k0:k0 + TILE])
        if join == "apart":
            pv = product(torch.zeros_like(o), parts(p), vt, steps, passes)
            o = (o.double() * corr.double() + pv.double()).float()
        else:
            o = product(o * corr, parts(p), vt, steps, passes)
    return (o / l.clamp_min(1e-30))[..., :hd]


def row_err(got, want) -> float:
    """The largest over the output rows of max |got - want| over that
    row's max-abs."""
    got, want = (np.asarray(a, np.float64) for a in (got, want))
    return float((np.abs(got - want).max(-1) / np.abs(want).max(-1)).max())


def inputs(B, K, G, S, hd, seed):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal(shape).astype(np.float32)
               for shape in ((B, K * G, S, hd), (B, K, S, hd), (B, K, S, hd)))
    return (q, k, v), tuple(torch.from_numpy(a) for a in (q, k, v))


# -- cvt.rna.tf32.f32 -------------------------------------------------------------

#: (input bits, cvt.rna's bits): below half of the dropped unit, a tie
#: with an even kept bit (away from zero, where round-to-even would stay),
#: a tie with an odd one, above half, a negative tie, a carry into the
#: exponent, a subnormal tie, and a tie at the top that rounds to infinity
RNA_CASES = [
    (0x3F800000, 0x3F800000), (0x3F800FFF, 0x3F800000),
    (0x3F801000, 0x3F802000), (0x3F803000, 0x3F804000),
    (0x3F801001, 0x3F802000), (0xBF801000, 0xBF802000),
    (0x3FFFF000, 0x40000000), (0x00001000, 0x00002000),
    (0x7F7FF000, 0x7F800000), (0x80000000, 0x80000000),
]


@pytest.mark.parametrize("bits,want", RNA_CASES,
                         ids=[f"{b:08x}" for b, _ in RNA_CASES])
def test_tf32_rounds_to_nearest_ties_away(bits, want):
    x = torch.tensor([bits], dtype=torch.int64)
    x = torch.where(x >= 2**31, x - 2**32, x).to(torch.int32).view(
        torch.float32)
    got = int(tf32(x).view(torch.int32).item()) & 0xFFFFFFFF
    assert got == want, f"{got:08x} != {want:08x}"


def test_tf32_keeps_ten_mantissa_bits():
    rng = np.random.default_rng(0)
    x = torch.from_numpy((rng.standard_normal(4096)
                          * 10.0 ** rng.integers(-20, 20, 4096))
                         .astype(np.float32))
    hi = tf32(x)
    assert not bool((hi.view(torch.int32) & 0x1FFF).any())
    assert float(((hi - x).abs() / x.abs()).max()) <= 2.0 ** -11


def test_hi_plus_lo_rebuilds_x():
    rng = np.random.default_rng(1)
    x = torch.from_numpy((rng.standard_normal(4096)
                          * 10.0 ** rng.integers(-20, 20, 4096))
                         .astype(np.float32))
    hi, lo = split(x)
    assert not bool((lo.view(torch.int32) & 0x1FFF).any())
    rebuilt = hi.double() + lo.double()
    assert float(((rebuilt - x.double()).abs() / x.double().abs()).max()) \
        <= 2.0 ** -21


# -- the tensor cores' sums --------------------------------------------------------

@pytest.mark.parametrize("sign", [1.0, -1.0], ids=["positive", "negative"])
def test_accumulator_rounds_toward_zero(sign):
    """1 + 3/4 of an ulp: to nearest it is 1 + ulp, the emulated
    accumulator keeps 1 (and -1 for the negative sum)."""
    acc = torch.full((1, 1), sign)
    a = torch.zeros((1, 8))
    a[0, 0] = sign
    b = torch.zeros((8, 1))
    b[0, 0] = 0.75 * 2.0 ** -23
    exact = acc.double() + a.double() @ b.double()
    assert float(exact.float()) == sign * (1 + 2.0 ** -23)
    assert float(mma(acc, a, b)) == sign


def test_qk_steps_take_every_column_once():
    steps = qk_steps(32)
    assert [len(s) for s in steps] == [8] * 4
    assert sorted(c for s in steps for c in s) == list(range(32))
    assert steps[0] == [0, 1, 4, 5, 8, 9, 12, 13]


def test_truncating_sums_cost_a_design_that_sums_into_o():
    """At S = 1024, hd = 128, causal: the kernel's design (each tile's P V
    apart, joined by one rounded FMA) keeps within half of the bar, while
    summing P V into O itself through 384 truncating k-steps a row takes
    more than half of it, as the two designs read on an H100 (6.40e-6 and
    1.53e-5)."""
    (q, k, v), (tq, tk, tv) = inputs(1, 2, 4, 1024, 128, seed=7)
    scale = 1.0 / math.sqrt(128)
    want = jref.flash_attention(*(jnp.asarray(a) for a in (q, k, v)),
                                scale=scale, causal=True)
    apart = row_err(emulate(tq, tk, tv, scale, True), want)
    into = row_err(emulate(tq, tk, tv, scale, True, join="into"), want)
    assert apart <= TOL_ROW / 2 < into, (apart, into)


# -- the attention ---------------------------------------------------------------

#: (hd, G, causal) at S = 256 (the Pallas kernel's 128-row tiles divide it)
CASES = [(hd, G, causal) for hd in (16, 64, 128) for G in (1, 4)
         for causal in (True, False)]


def case_id(c):
    hd, G, causal = c
    return f"hd{hd}-G{G}-{'causal' if causal else 'full'}"


@pytest.mark.parametrize("hd,G,causal", CASES, ids=map(case_id, CASES))
def test_3xtf32_matches_pallas_and_ref(hd, G, causal):
    (q, k, v), (tq, tk, tv) = inputs(1, 2, G, 256, hd, seed=hd + G)
    scale = 1.0 / math.sqrt(hd)
    got = emulate(tq, tk, tv, scale, causal).numpy()
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    pallas = flash_attention_pallas(jq, jk, jv, scale=scale, causal=causal,
                                    block_q=128, block_k=128, interpret=True)
    want = jref.flash_attention(jq, jk, jv, scale=scale, causal=causal)
    assert row_err(got, pallas) <= TOL_ROW
    assert row_err(got, want) <= TOL_ROW


@pytest.mark.parametrize("hd,G,causal", CASES, ids=map(case_id, CASES))
def test_3xtf32_matches_ref_on_a_ragged_sequence(hd, G, causal):
    """S = 300: no multiple of the kernel's tiles (the Pallas kernel
    asserts that its tiles divide S, so only the reference here)."""
    (q, k, v), (tq, tk, tv) = inputs(1, 2, G, 300, hd, seed=3 * hd + G)
    scale = 1.0 / math.sqrt(hd)
    got = emulate(tq, tk, tv, scale, causal).numpy()
    want = jref.flash_attention(*(jnp.asarray(a) for a in (q, k, v)),
                                scale=scale, causal=causal)
    assert row_err(got, want) <= TOL_ROW


@pytest.mark.parametrize("hd,G,causal", CASES, ids=map(case_id, CASES))
def test_one_tf32_pass_misses_the_bar(hd, G, causal):
    """On the same inputs one TF32 pass per product is off by more than
    2e-5 per row: the bar tells 3xTF32 from 1xTF32."""
    (q, k, v), (tq, tk, tv) = inputs(1, 2, G, 256, hd, seed=hd + G)
    scale = 1.0 / math.sqrt(hd)
    want = jref.flash_attention(*(jnp.asarray(a) for a in (q, k, v)),
                                scale=scale, causal=causal)
    assert row_err(emulate(tq, tk, tv, scale, causal, passes=1),
                   want) > TOL_ROW
