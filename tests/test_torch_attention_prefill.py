"""The prefill route of the port's attention (`csrc/flash_prefill.cu`) on
the CPU: the rule that picks it (`attention_route`), the buffers it
needs (no split partials), its tile walk (`prefill_tiles`) against a
brute-force mask, and its arithmetic in plain PyTorch
(`flash_prefill_ref`: the walk in order, P split into bf16 high and low
parts) against the JAX package's Pallas body in interpret mode and
against `flash_ref`, on the same numpy inputs.

The CUDA kernel itself runs only on the card (`tests/test_torch_card.py`,
`chip_smoke.py`).  Inputs are bf16 values held in f32, the kernel's own
operands; tolerances are `attention_tol(float32)` (2e-4 + 2e-4·|ref|,
the reference tests' f32 tolerance).  Every compared row sees at least
one key (the Pallas body and the kernel differ on a row that sees none;
ROADMAP queue C)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention as jflash_attention
from repro_torch.kernels.flash_attention import (
    attention_buffers,
    attention_route,
    attention_tol,
    flash_prefill_ref,
    flash_ref,
    kv_splits,
    prefill_tiles,
)
from repro_torch.kernels.flash_attention import kernel as K

BF16 = torch.bfloat16


def _meta(B, Hq, Hkv, T, S, D, Dv, dtype=BF16):
    return (torch.empty((B, Hq, T, D), dtype=dtype, device="meta"),
            torch.empty((B, Hkv, S, D), dtype=dtype, device="meta"),
            torch.empty((B, Hkv, S, Dv), dtype=dtype, device="meta"))


# ------------------------------------------------------------------- route
# (B, Hq, Hkv, T, S, D, Dv, dtype, route)
ROUTE_TABLE = {
    "qwen3-14b prefill": (4, 40, 8, 1000, 1033, 128, 128, BF16, "prefill"),
    "zamba2-1.2b prefill": (4, 32, 32, 1000, 1033, 64, 64, BF16, "prefill"),
    "deepseek-v2-lite prefill (MLA 192/128)": (4, 16, 16, 1000, 1000, 192, 128, BF16,
                                              "prefill"),
    "gemma3-27b local prefill": (4, 32, 16, 2048, 2057, 128, 128, BF16, "prefill"),
    "stablelm-3b prefill (D 80)": (4, 32, 32, 1000, 1009, 80, 80, BF16, "prefill"),
    "qwen2-72b prefill": (4, 64, 8, 1000, 1009, 128, 128, BF16, "prefill"),
    "deepseek-v2-236b prefill": (4, 128, 128, 1000, 1000, 192, 128, BF16, "prefill"),
    "qwen3-14b rank of 4": (4, 10, 2, 1000, 1009, 128, 128, BF16, "prefill"),
    "training (T 512, no cache)": (4, 32, 32, 512, 512, 64, 64, BF16, "prefill"),
    "SLO prompt piece": (1, 40, 8, 342, 854, 128, 128, BF16, "prefill"),
    "qwen3-14b decode member": (16, 40, 8, 1, 4096, 128, 128, BF16, "decode"),
    "zamba2 decode member": (16, 32, 32, 1, 2048, 64, 64, BF16, "decode"),
    "MLA decode member": (16, 16, 16, 1, 2048, 192, 128, BF16, "decode"),
    "f32 prefill": (4, 40, 8, 1000, 1033, 128, 128, torch.float32, "decode"),
    "D 36 (72-byte rows)": (1, 8, 2, 300, 300, 36, 36, BF16, "decode"),
    "D 256 (no instantiation)": (1, 4, 4, 300, 300, 256, 256, BF16, "decode"),
    "192/192 (no instantiation)": (1, 4, 4, 300, 300, 192, 192, BF16, "decode"),
    "D 32 on the 64-wide kernel": (1, 4, 4, 64, 2000, 32, 32, BF16, "prefill"),
    "T one below the threshold": (4, 40, 8, K.PREFILL_MIN_T - 1, 1033, 128, 128, BF16,
                                  "decode"),
    "T at the threshold": (4, 40, 8, K.PREFILL_MIN_T, 1033, 128, 128, BF16, "prefill"),
}


@pytest.mark.parametrize("name", ROUTE_TABLE, ids=list(ROUTE_TABLE))
def test_attention_route_table(name):
    """The route by shape and dtype: the models' prefills (bf16, T at the
    threshold or above, head dims an instantiation holds) on "prefill";
    decode members, f32, rows not 16-byte multiples and widths no
    instantiation holds on "decode"."""
    *shape, dtype, route = ROUTE_TABLE[name]
    assert attention_route(*_meta(*shape, dtype=dtype)) == route


def test_prefill_widths_pick_the_smallest_instantiation():
    assert [K.prefill_width(D, Dv) for D, Dv in
            ((32, 32), (64, 64), (80, 80), (128, 64), (128, 128), (192, 128),
             (136, 128), (192, 192), (256, 256))] == \
        [(64, 64), (64, 64), (128, 128), (128, 128), (128, 128), (192, 128),
         (192, 128), None, None]
    assert K.prefill_grid(4, 40, 1000) == (160, 8)
    assert K.prefill_grid(1, 1, 128) == (1, 1) and K.prefill_grid(1, 1, 129) == (1, 2)


# ----------------------------------------------------------------- buffers
@pytest.mark.parametrize("shape,splits", [
    ((1, 40, 8, 1, 4096, 128, 128), 16),   # decode at batch 1: split partials
    ((16, 40, 8, 1, 4096, 128, 128), 2),
    ((1, 4, 2, 300, 3000, 64, 64), 1),     # prefill route: kv_splits would split
    ((4, 40, 8, 1000, 1033, 128, 128), 1),
    ((4, 16, 16, 1000, 1000, 192, 128), 1),
])
def test_prefill_buffers_hold_no_split_partials(shape, splits, monkeypatch):
    """`attention_buffers` off the CPU (meta tensors, a stubbed slot count
    of 264 = 132 SMs × 2) allocates split partials and the row groups'
    counters for a decode-route launch the kv range splits, and none on
    the prefill route, which splits nothing — even where `kv_splits`
    would cut that shape's kv range."""
    monkeypatch.setattr(K, "resident_slots", lambda *_: 264)
    q, k, v = _meta(*shape)
    B, Hq, Hkv, T, S, D, Dv = shape
    bufs = attention_buffers(q, k, v)
    assert bufs.out.shape == (B, Hq, T, Dv) and bufs.out.dtype == BF16
    assert K.attention_splits(q, k, v)[0] == splits
    if attention_route(q, k, v) == "prefill":
        assert kv_splits(1, 2, 2, 300, 3000, 264 * 4)[0] > 1
        assert bufs.part_acc is None and bufs.part_ml is None and bufs.counter is None
    elif splits > 1:
        assert bufs.part_acc.shape == (splits, B, Hq, T, Dv)
        assert bufs.part_ml.shape == (splits, B, Hq, T, 2)
        assert bufs.counter.shape == (B, Hq, T)


# --------------------------------------------------------------- tile walk
def _visible(T, S, q_offset, causal, window):
    qpos = np.arange(T)[:, None] + q_offset
    kpos = np.arange(S)[None, :]
    vis = np.ones((T, S), dtype=bool)
    if causal:
        vis &= kpos <= qpos
    if window:
        vis &= qpos - kpos < window
    return vis


# (T, S, q_offset, causal, window)
WALK_CASES = [
    (1, 1, 0, True, 0), (63, 63, 0, True, 0), (64, 64, 0, True, 0),
    (65, 200, 0, True, 0), (127, 127, 0, True, 0), (128, 128, 0, True, 0),
    (129, 129, 0, True, 0), (300, 333, 33, True, 0), (1000, 1033, 0, True, 0),
    (200, 1200, 1000, True, 0), (100, 100, -50, True, 0), (50, 300, -200, True, 0),
    (300, 300, 0, True, 1), (300, 300, 0, True, 100), (2048, 2057, 0, True, 1024),
    (300, 500, 200, True, 128), (90, 400, 310, True, 150), (257, 300, 0, True, 129),
    (100, 180, 0, False, 0), (130, 130, 0, False, 64), (64, 2000, 1936, True, 100),
    (70, 1500, -10, True, 0), (513, 700, 187, True, 0), (200, 64, 0, False, 0),
]


@pytest.mark.parametrize("case", WALK_CASES, ids=str)
def test_prefill_tiles_cover_every_visible_pair_once(case):
    """The walk against a brute-force mask: every visible (query, key)
    pair lies in exactly one loaded tile that its warpgroup computes;
    every pair of an "open" tile is visible, no pair of a "skip" tile is;
    tiles are whole `PREFILL_KV_TILE` blocks inside [0, S), in order, each
    computed by at least one warpgroup (no load is wasted), and the tiles
    a warpgroup computes are one run of the walk (the kernel pipelines
    that run)."""
    T, S, off, causal, window = case
    vis = _visible(T, S, off, causal, window)
    cover = np.zeros((T, S), dtype=np.int64)
    kt, wr = K.PREFILL_KV_TILE, K.PREFILL_WG_ROWS
    blocks = prefill_tiles(T, S, causal=causal, window=window, q_offset=off)
    assert [q0 for q0, _ in blocks] == list(range(0, T, K.PREFILL_ROWS))
    for q0, tiles in blocks:
        starts = [t.k0 for t in tiles]
        assert starts == sorted(starts) and all(0 <= s < S and s % kt == 0 for s in starts)
        for wg in range(2):
            runs = "".join("s" if t.modes[wg] == "skip" else "c" for t in tiles)
            assert "cs" not in runs.strip("s") and "sc" not in runs.strip("s"), runs
        for t in tiles:
            assert any(m != "skip" for m in t.modes), (q0, t)
            keys = slice(t.k0, min(t.k0 + kt, S))
            for wg, mode in enumerate(t.modes):
                rows = slice(q0 + wg * wr, min(q0 + (wg + 1) * wr, T))
                block = vis[rows, keys]
                if mode == "skip":
                    assert not block.any(), (q0, t, wg)
                    continue
                if mode == "open":
                    assert block.all() and t.k0 + kt <= S, (q0, t, wg)
                cover[rows, keys] += 1
    assert (cover[vis] == 1).all()


# ------------------------------------------------- plain tiled arithmetic
def _inputs(seed, B, Hq, Hkv, T, S, D, Dv):
    """Normal inputs rounded to bf16 (the kernel's operands), held in f32."""
    rng = np.random.default_rng(seed)
    arrays = (rng.standard_normal((B, Hq, T, D)), rng.standard_normal((B, Hkv, S, D)),
              rng.standard_normal((B, Hkv, S, Dv)))
    return [torch.from_numpy(a.astype(np.float32)).to(BF16).float() for a in arrays]


def _close(got, want, seen, what):
    atol, rtol = attention_tol(torch.float32)
    g, w = got[:, :, seen], want[:, :, seen]
    err = (g - w).abs()
    assert bool((err <= atol + rtol * w.abs()).all()), f"{what}: max |err| {err.max():.3g}"


# (B, Hq, Hkv, T, S, D, Dv, causal, window, q_offset)
PREFILL_CASES = {
    "rep1-d64": (1, 2, 2, 200, 200, 64, 64, True, 0, 0),
    "rep4-cache-suffix": (1, 8, 2, 150, 300, 64, 64, True, 0, 150),
    "rep5-d128-written-cache": (1, 5, 1, 130, 170, 128, 128, True, 0, 0),
    "mla-192-128-ragged": (1, 4, 4, 140, 140, 192, 128, True, 0, 0),
    "window": (2, 4, 2, 300, 300, 64, 64, True, 100, 0),
    "window-after-a-prefix": (1, 4, 1, 90, 400, 64, 64, True, 150, 310),
    "non-causal": (1, 2, 1, 100, 180, 64, 64, False, 0, 0),
    "d80": (1, 2, 2, 70, 80, 80, 80, True, 0, 0),
    "negative-offset": (1, 4, 2, 100, 160, 64, 32, True, 0, -30),
}


@pytest.mark.parametrize("case", PREFILL_CASES, ids=list(PREFILL_CASES))
def test_prefill_plain_version_matches_pallas_interpret(case):
    """`flash_prefill_ref` (the prefill kernel's tile walk and split P)
    against the JAX package's `flash_attention` (its Pallas body in
    interpret mode, bq = bkv = 128) and against `flash_ref`, within
    `attention_tol(float32)`: rep 1, 2, 4 and 5, D 64, 80, 128 and
    192/128, ragged T, S > T, a window, a q_offset either way."""
    B, Hq, Hkv, T, S, D, Dv, causal, window, off = PREFILL_CASES[case]
    q, k, v = _inputs(list(PREFILL_CASES).index(case), B, Hq, Hkv, T, S, D, Dv)
    kw = dict(causal=causal, window=window, q_offset=off)
    got = flash_prefill_ref(q, k, v, **kw)
    assert got.shape == (B, Hq, T, Dv) and got.dtype == torch.float32
    want = jflash_attention(*(jnp.asarray(t.numpy()) for t in (q, k, v)), bq=128,
                            bkv=128, interpret=True, **kw)
    seen = _visible(T, S, off, causal, window).any(1)
    assert seen.any()
    _close(got, torch.from_numpy(np.array(want, dtype=np.float32)), seen,
           f"{case} vs Pallas")
    _close(got, flash_ref(q, k, v, **kw), seen, f"{case} vs flash_ref")
    assert not got[:, :, ~seen].any()       # a row that sees no key writes 0


def test_p_rounded_once_to_bf16_misses_the_tolerance():
    """Why the kernel splits P: with P rounded once to bf16 (up to 2⁻⁹ of
    each weight), rows whose weighted values nearly cancel miss
    `attention_tol`'s 2e-4 floor at a prefill's early rows; the split
    (high + low bf16 parts) stays within it."""
    q, k, v = _inputs(5, 1, 4, 1, 200, 200, 64, 64)
    ref = flash_ref(q, k, v)
    atol, rtol = attention_tol(torch.float32)

    def beyond(out):
        return int(((out - ref).abs() > atol + rtol * ref.abs()).sum())

    assert beyond(flash_prefill_ref(q, k, v)) == 0
    assert beyond(flash_prefill_ref(q, k, v, precision="bf16")) > 0
    with pytest.raises(ValueError, match="precision"):
        flash_prefill_ref(q, k, v, precision="fp16")


def test_prefill_planted_faults_fail_the_tolerance():
    """The faults `chip_smoke.py` plants on the prefill route, here on the
    plain version at reduced Qwen3 widths (rep 5, D 128): a walk that
    skips one kv tile for the rows past it, and a diagonal tile computed
    without its mask, each move most of the affected rows beyond
    `attention_tol`."""
    T, kt = 512, K.PREFILL_KV_TILE
    q, k, v = _inputs(9, 1, 5, 1, T, T, 128, 128)
    ref = flash_ref(q, k, v)
    atol, rtol = attention_tol(torch.bfloat16)
    lo = kt
    keep = torch.ones(T, dtype=torch.bool)
    keep[lo:lo + kt] = False
    rows = slice(lo + kt, T)
    skipped = flash_prefill_ref(q[:, :, rows], k[:, :, keep], v[:, :, keep],
                                q_offset=lo).to(BF16).float()
    bad = ((skipped - ref[:, :, rows]).abs() > atol + rtol * ref[:, :, rows].abs())
    assert bad.float().mean() > 0.25
    q0 = 2 * K.PREFILL_ROWS
    unmasked = flash_prefill_ref(q[:, :, q0:q0 + K.PREFILL_ROWS],
                                 k[:, :, :q0 + K.PREFILL_ROWS],
                                 v[:, :, :q0 + K.PREFILL_ROWS], causal=False).to(BF16)
    want = ref[:, :, q0:q0 + K.PREFILL_ROWS]
    bad = (unmasked.float() - want).abs() > atol + rtol * want.abs()
    assert bad.float().mean() > 0.25
