"""The port's attention op (`repro_torch.kernels.flash_attention`) on the
CPU against the JAX package's Pallas body in interpret mode, on the same
numpy inputs.

On CPU tensors `flash_attention` runs its plain version (`flash_ref`);
the CUDA kernel itself runs only on the card (`chip_smoke.py`).
Tolerances are the reference tests' own (`tests/test_kernel_attention.py`):
2e-4 in f32, 3e-2 in bf16.  Every compared row sees at least one key
(the kernels and the plain versions differ on rows that see none;
ROADMAP queue C)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.op_desc import AttentionDesc as JAttn
from repro.kernels.flash_attention.ops import attention_for_desc as jattention_for_desc
from repro.kernels.flash_attention.ops import flash_attention as jflash_attention
from repro.kernels.flash_attention.ref import flash_ref as jflash_ref
from repro.kernels.flash_attention.ref import mha_ref as jmha_ref
from repro_torch.core import AttentionDesc
from repro_torch.kernels.flash_attention import (
    attention_for_desc,
    attention_tol,
    flash_attention,
    flash_attention_fwd,
    flash_ref,
    mha_ref,
)
from repro_torch.kernels.flash_attention.kernel import attention_shapes, width_for
from repro_torch.kernels.gemm import TileConfig

TOL = {"f32": 2e-4, "bf16": 3e-2}
JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"f32": torch.float32, "bf16": torch.bfloat16}


def _qkv(seed, B, Hq, Hkv, T, S, D, Dv=None):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Hq, T, D)).astype(np.float32) * 0.5,
            rng.standard_normal((B, Hkv, S, D)).astype(np.float32) * 0.5,
            rng.standard_normal((B, Hkv, S, Dv or D)).astype(np.float32) * 0.5)


def _both(arrays, dtype):
    port = [torch.from_numpy(a).to(TDT[dtype]) for a in arrays]
    ref = [jnp.asarray(a).astype(JDT[dtype]) for a in arrays]
    return port, ref


def _close(got, want, dtype):
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(jnp.asarray(want).astype(jnp.float32)),
        rtol=TOL[dtype], atol=TOL[dtype])


# (B, Hq, Hkv, T, S, D, Dv, causal, window, bq, bkv)
CASES = {
    "gqa-causal-ragged-S": (1, 4, 2, 37, 250, 32, 32, True, 0, 8, 128),
    "decode-gqa": (2, 10, 2, 1, 300, 64, 64, True, 0, 8, 128),
    "decode-mha": (3, 4, 4, 1, 129, 32, 32, True, 0, 8, 128),
    "window": (1, 4, 4, 64, 200, 32, 32, True, 16, 64, 128),
    "prefill-q-offset": (2, 2, 1, 130, 250, 32, 32, True, 0, 64, 256),
    "non-causal": (1, 2, 2, 20, 100, 32, 32, False, 0, 8, 128),
    "dv-ne-dqk": (1, 4, 2, 9, 140, 32, 16, True, 0, 8, 128),
}


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("case", CASES, ids=list(CASES))
def test_flash_attention_matches_pallas_interpret(case, dtype):
    B, Hq, Hkv, T, S, D, Dv, causal, window, bq, bkv = CASES[case]
    off = S - T if causal else 0
    (q, k, v), (jq, jk, jv) = _both(_qkv(list(CASES).index(case), B, Hq, Hkv, T, S,
                                         D, Dv), dtype)
    got = flash_attention(q, k, v, causal=causal, window=window, q_offset=off,
                          bq=bq, bkv=bkv)
    want = jflash_attention(jq, jk, jv, causal=causal, window=window,
                            q_offset=off, bq=bq, bkv=bkv, interpret=True)
    assert got.shape == (B, Hq, T, Dv) and got.dtype == TDT[dtype]
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("case", ["gqa-causal-ragged-S", "window", "dv-ne-dqk"])
def test_plain_versions_match_reference_plain_versions(case, dtype):
    B, Hq, Hkv, T, S, D, Dv, causal, window, _, _ = CASES[case]
    off = S - T if causal else 0
    (q, k, v), (jq, jk, jv) = _both(_qkv(7, B, Hq, Hkv, T, S, D, Dv), dtype)
    kw = dict(causal=causal, window=window, q_offset=off)
    if Dv == D:
        _close(mha_ref(q, k, v, **kw), jmha_ref(jq, jk, jv, **kw), dtype)
    for block in (64, 512):
        _close(flash_ref(q, k, v, block_kv=block, **kw),
               jflash_ref(jq, jk, jv, block_kv=block, **kw), dtype)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("tile", [None, TileConfig(8, 128, 128),
                                  TileConfig(256, 512, 128),
                                  TileConfig(4, 64, 128)],
                         ids=lambda t: "none" if t is None else t.key())
def test_attention_for_desc_matches_reference(tile, dtype):
    """The descriptor adapter: decode and prefill members at GO tiles
    (bm → bq clamped to [8, 512], bn → bkv to [128, 512]) with the
    suffix alignment q_offset = Skv − Sq."""
    for seed, (B, Hq, Hkv, Sq, Skv, D) in enumerate(((3, 8, 2, 1, 300, 32),
                                                      (1, 4, 4, 24, 160, 32))):
        desc = AttentionDesc(B, Hq, Hkv, Sq, Skv, D, True, dtype)
        jdesc = JAttn(B, Hq, Hkv, Sq, Skv, D, True, dtype)
        (q, k, v), (jq, jk, jv) = _both(_qkv(seed, B, Hq, Hkv, Sq, Skv, D),
                                        dtype)
        _close(attention_for_desc(desc, q, k, v, tile=tile),
               jattention_for_desc(jdesc, jq, jk, jv, tile=tile, interpret=True),
               dtype)


def test_cuda_path_never_falls_back_to_the_plain_version():
    """Off the CPU the op reaches the CUDA launcher, which refuses a
    non-CUDA tensor and counts no launch."""
    q = torch.empty((1, 2, 1, 32), device="meta")
    k = torch.empty((1, 2, 64, 32), device="meta")
    before = flash_attention_fwd.launches
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        flash_attention(q, k, k)
    assert flash_attention_fwd.launches == before


def test_launcher_checks_shapes_before_launching():
    q = torch.empty((1, 3, 1, 32), device="meta")
    k = torch.empty((1, 2, 64, 32), device="meta")
    with pytest.raises(ValueError, match="multiple of Hkv"):
        attention_shapes(q, k, k)
    assert [width_for(d, d) for d in (16, 64, 65, 128, 200)] == [64, 64, 128, 128, 256]
    assert width_for(192, 128) == 256
    with pytest.raises(ValueError, match="exceed"):
        width_for(320, 64)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_kernel_tolerance_passes_reordered_sums_and_fails_a_skipped_subtile(dtype):
    """`attention_tol`, the bound `chip_smoke.py` holds the CUDA kernel to
    at the Qwen3-14B decode member's widths (GQA 40/8, D 128, 4,096 keys,
    N(0, 1) inputs): the same function summed over other kv blocks and
    rounded once to the output dtype passes; the output of a kernel that
    skipped one 64-key sub-tile fails."""
    B, Hq, Hkv, S, D = 2, 40, 8, 4096, 128
    g = torch.Generator().manual_seed(14)
    q, k, v = (torch.randn(shape, generator=g).to(TDT[dtype]).float()
               for shape in ((B, Hq, 1, D), (B, Hkv, S, D), (B, Hkv, S, D)))
    ref = flash_ref(q, k, v, q_offset=S - 1)
    atol, rtol = attention_tol(TDT[dtype])

    def beyond(out):
        return ((out.float() - ref).abs() > atol + rtol * ref.abs()).sum().item()

    assert beyond(flash_ref(q, k, v, q_offset=S - 1, block_kv=64).to(TDT[dtype])) == 0
    keep = torch.ones(S, dtype=torch.bool)
    keep[2048:2112] = False
    skipped = flash_ref(q, k[:, :, keep], v[:, :, keep], q_offset=S - 65).to(TDT[dtype])
    assert beyond(skipped) > 0.25 * skipped.numel()
