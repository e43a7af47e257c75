"""The resolve of the port against the JAX package: every variant of
`resolve`, `hdr_bitmap` and `lut_blended_resolve`, the tonemap operators
and the uint8 quantization, on the same numpy inputs from a seed."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from illuminant_tpu.core.config import HDRConfig as JHDR
from illuminant_tpu.ops import tonemap as jtone
from illuminant_tpu.raster import lut as jlut
from illuminant_tpu.raster import resolve as jres
from illuminant_tpu_torch.core.config import HDRConfig
from illuminant_tpu_torch.ops import tonemap
from illuminant_tpu_torch.raster import lut, resolve

torch.set_num_threads(1)

H, W = 24, 36
# XLA on the CPU and PyTorch round pow, the sRGB pieces and the tonemap's
# white-point division an ulp or two apart: the float image is held to
# 1e-5 absolute on values in [0, ~4], the uint8 image to 1 LSB.
ATOL = 1e-5


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    lightmap = rng.uniform(0.0, 3.0, (H, W, 4)).astype(np.float32)
    lightmap[..., 3] = rng.uniform(0.0, 1.5, (H, W))
    lightmap[:2] -= 1.0  # a subtractive light went below zero
    albedo = rng.uniform(0.0, 1.0, (H, W, 4)).astype(np.float32)
    albedo[..., :3] *= albedo[..., 3:4]  # premultiplied
    return lightmap, albedo


HDRS = {
    "none": dict(mode=0, exposure=1.2, gamma=0.9, offset=0.05),
    "gamma_compress": dict(mode=1, middle_gray=0.5, maximum_luminance_sq=4.0,
                           offset=0.02),
    "tonemap": dict(mode=2, exposure=1.3, white_point=4.0, gamma=1.1),
}
EXTRAS = {
    "plain": {},
    "srgb": dict(srgb_output=True),
    "srgb_dither": dict(srgb_output=True, dithering=True),
}


@pytest.mark.parametrize("extra", sorted(EXTRAS))
@pytest.mark.parametrize("with_albedo", ["albedo", "albedo3_srgb", "none"])
@pytest.mark.parametrize("mode", sorted(HDRS))
def test_resolve_matches_jax(mode, with_albedo, extra):
    """The six Resolve.fx variants ({none, gamma-compress, tonemap} x
    {albedo, none}), a 3-channel sRGB-authored albedo, the sRGB output and
    the dither: float image within 1e-5, uint8 image within 1 LSB with at
    most 1% of values off by it."""
    lightmap, albedo = _inputs()
    kw = dict(HDRS[mode], **EXTRAS[extra])
    args = dict(inverse_scale=1.5, average_luminance=0.4)
    if with_albedo == "albedo":
        alb = albedo
    elif with_albedo == "albedo3_srgb":
        alb = albedo[..., :3]
        args["albedo_is_srgb"] = True
    else:
        alb = None
    ref = jres.resolve(jnp.asarray(lightmap), JHDR(**kw),
                       albedo=None if alb is None else jnp.asarray(alb),
                       **args)
    out = resolve.resolve(torch.as_tensor(lightmap), HDRConfig(**kw),
                          albedo=None if alb is None else torch.as_tensor(alb),
                          **args)
    assert out.shape == (H, W, 4) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                               atol=ATOL)
    d8 = np.abs(resolve.to_uint8(out).numpy().astype(np.int32)
                - np.asarray(jres.to_uint8(ref)).astype(np.int32))
    assert d8.max() <= 1 and (d8 > 0).mean() <= 0.01, (d8.max(),
                                                       (d8 > 0).mean())


def test_resolve_rejects_unknown_mode():
    lightmap, _ = _inputs()
    with pytest.raises(ValueError, match="HDR mode"):
        resolve.resolve(torch.as_tensor(lightmap), HDRConfig(mode=7))


def test_to_uint8_rounds_half_to_even_and_clamps():
    x = np.asarray([[[-0.2, 0.5 / 255.0, 1.5 / 255.0, 2.5 / 255.0, 0.999,
                      1.7]]], np.float32)
    np.testing.assert_array_equal(
        resolve.to_uint8(torch.as_tensor(x)).numpy(),
        np.asarray(jres.to_uint8(jnp.asarray(x))))


@pytest.mark.parametrize("extra", sorted(EXTRAS))
@pytest.mark.parametrize("mode", sorted(HDRS))
def test_hdr_bitmap_matches_jax(mode, extra):
    tex, _ = _inputs(1)
    tex = np.abs(tex)
    kw = dict(HDRS[mode], **EXTRAS[extra])
    args = dict(multiply_color=(0.9, 0.8, 1.1, 0.7),
                add_color=(0.1, 0.0, 0.2, 0.5), inverse_scale=2.0,
                average_luminance=0.3)
    ref = np.asarray(jres.hdr_bitmap(jnp.asarray(tex), JHDR(**kw), **args))
    out = resolve.hdr_bitmap(torch.as_tensor(tex), HDRConfig(**kw), **args)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=ATOL)


def _luts():
    rng = np.random.default_rng(2)
    ident = jlut.identity_lut(8)
    np.testing.assert_array_equal(ident, lut.identity_lut(8))
    dark = np.clip(ident * 0.6 + rng.uniform(0, 0.05, ident.shape), 0, 1)
    bright = np.clip(ident ** 0.8 + rng.uniform(0, 0.05, ident.shape), 0, 1)
    return dark.astype(np.float32), bright.astype(np.float32)


def test_sample_lut_matches_jax():
    dark, _ = _luts()
    rng = np.random.default_rng(3)
    rgb = rng.uniform(-0.1, 1.1, (H, W, 3)).astype(np.float32)
    rgb[0, 0] = [0.0, 1.0, 0.5]
    np.testing.assert_allclose(
        lut.sample_lut(torch.as_tensor(dark), torch.as_tensor(rgb)).numpy(),
        np.asarray(jlut.sample_lut(jnp.asarray(dark), jnp.asarray(rgb))),
        rtol=0, atol=1e-6)
    # The identity LUT returns the clamped colour.
    np.testing.assert_allclose(
        lut.sample_lut(torch.as_tensor(lut.identity_lut(16)),
                       torch.as_tensor(rgb)).numpy(),
        np.clip(rgb, 0.0, 1.0), rtol=0, atol=1e-6)


LUT_CONFIGS = {
    "luma_weight": dict(),
    "per_channel": dict(per_channel=True, dark_level=0.2, bright_level=1.4),
    "neutral_band": dict(dark_level=0.1, bright_level=0.9,
                         neutral_band_size=0.3),
    "neutral_band_per_channel": dict(per_channel=True, dark_level=0.1,
                                     bright_level=0.9,
                                     neutral_band_size=0.3),
    "lut_only": dict(lut_only=True),
    "levels_crossed": dict(dark_level=0.8, bright_level=0.3,
                           neutral_band_size=0.2),
    "dark_only": dict(bright=False),
    "defaults": dict(dark=False, bright=False),
}


@pytest.mark.parametrize("name", sorted(LUT_CONFIGS))
def test_lut_blended_resolve_matches_jax(name):
    """LUTResolve.fx:60-115 in each of its branches: the luma and the
    per-channel weight, the neutral band, LUT-only output, crossed levels
    (no band), a missing bright LUT and the identity default. Float
    values in [0, ~3] within 1e-5."""
    kw = dict(LUT_CONFIGS[name])
    dark, bright = _luts()
    luts = dict(dark_lut=dark if kw.pop("dark", True) else None,
                bright_lut=bright if kw.pop("bright", True) else None)
    lightmap, albedo = _inputs(4)
    ref = np.asarray(jlut.lut_blended_resolve(
        jnp.asarray(albedo), jnp.asarray(lightmap),
        jlut.LUTBlendingConfiguration(**luts, **kw), inverse_scale=1.25))
    out = lut.lut_blended_resolve(
        torch.as_tensor(albedo), torch.as_tensor(lightmap),
        lut.LUTBlendingConfiguration(**luts, **kw), inverse_scale=1.25)
    assert out.shape == (H, W, 4)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=ATOL)


def test_tonemap_operators_match_jax():
    """The operators `resolve` does not reach directly, and the ones it
    does on their own."""
    lightmap, _ = _inputs(5)
    x = np.abs(lightmap)
    xt, xj = torch.as_tensor(x), jnp.asarray(x)
    pairs = [
        (tonemap.uncharted2_resolve(xt, 1.3, 4.0),
         jtone.uncharted2_resolve(xj, 1.3, 4.0)),
        (tonemap.gamma_compress(xt, 0.1, 0.6, 0.45, 2.0),
         jtone.gamma_compress(xj, 0.1, 0.6, 0.45, 2.0)),
        (tonemap.apply_exposure_gamma(xt, 1.4, 0.8),
         jtone.apply_exposure_gamma(xj, 1.4, 0.8)),
        (tonemap.srgb_to_linear(xt / 3.0), jtone.srgb_to_linear(xj / 3.0)),
        (tonemap.linear_to_srgb(xt / 3.0), jtone.linear_to_srgb(xj / 3.0)),
        (tonemap.luminance(xt[..., :3]), jtone.luminance(xj[..., :3])),
        (tonemap.ordered_dither(
            xt[..., :3], torch.arange(H)[:, None], torch.arange(W)[None, :],
            0.1),
         jtone.ordered_dither(xj[..., :3], jnp.arange(H)[:, None],
                              jnp.arange(W)[None, :], 0.1)),
    ]
    for out, ref in pairs:
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                                   atol=ATOL)
    # The sRGB pair inverts itself.
    s = torch.linspace(0.0, 1.0, 101)
    np.testing.assert_allclose(
        tonemap.srgb_to_linear(tonemap.linear_to_srgb(s)).numpy(), s.numpy(),
        atol=1e-6)
