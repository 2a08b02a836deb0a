"""tinycarlo_torch.models against the JAX package's flax models: the
TinycarCombo with the bundled pretrained weights and with a random init,
converted by convert.combo_state_dict_from_flax, on the same numpy-seeded
frames; `pre_obs` / `pre_obs_rank` layouts; `load_pretrained`.

Tolerances, float32 on the CPU: actions within 1e-5 absolute, encoder
features within 1e-5 absolute plus 1e-5 relative (XLA's and torch's CPU
convolutions sum in different orders; the features reach ~10). The
preprocessing is exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinycarlo_torch import convert
from tinycarlo_torch.models import tinycar_net as pnet
from tinycarlo_tpu.models import tinycar_net as jnet
from tinycarlo_tpu.train.il import load_variables_npz as jax_load_npz

BUNDLED = ("tinycarlo_tpu/models/pretrained/"
           "tinycar_combo_flax_3_128_160.npz")


def _frames(seed, shape):
    return np.random.default_rng(seed).integers(0, 256, shape).astype(
        np.uint8)


def _maneuvers(b):
    return np.eye(3, dtype=np.float32)[np.arange(b) % 3]


def _jax_forward(variables, frames, mh):
    """Flax combo output and encoder features on (B, H, W, C) uint8."""
    model = jnet.TinycarCombo()
    x = jnet.pre_obs(jnp.asarray(frames))
    out = model.apply(variables, x, jnp.asarray(mh))
    feats = jnet.TinycarEncoder().apply(
        {"params": variables["params"]["encoder"],
         "batch_stats": variables["batch_stats"]["encoder"]}, x)
    return np.asarray(out), np.asarray(feats)


def _torch_forward(model, frames, mh):
    with torch.no_grad():
        x = pnet.pre_obs(torch.from_numpy(frames))
        return (model(x, torch.from_numpy(mh)).numpy(),
                model.encoder(x).numpy())


def _assert_forward(got, want):
    out, feats = got
    jout, jfeats = want
    assert out.dtype == np.float32 and out.shape == jout.shape
    np.testing.assert_allclose(out, jout, rtol=0, atol=1e-5)
    np.testing.assert_allclose(feats, jfeats, rtol=1e-5, atol=1e-5)


def test_bundled_combo_matches_flax():
    """load_pretrained's combo equals flax TinycarCombo.apply with the same
    npz on seeded 128x160x3 frames, B = 4."""
    model = pnet.load_pretrained((3, 128, 160), device="cpu")
    assert not model.training
    frames = _frames(0, (4, 128, 160, 3))
    mh = _maneuvers(4)
    want = _jax_forward(jax_load_npz(BUNDLED), frames, mh)
    _assert_forward(_torch_forward(model, frames, mh), want)
    assert np.abs(want[0]).max() > 0.05  # the policy steers


def test_random_init_converts_at_other_shapes():
    """A random flax init of a 5-class combo at 64x160 (the (2, 5)
    encoder output): the converted state dict gives flax's outputs, so the
    dense rows' permutation holds for a non-square flatten too."""
    frames = _frames(1, (3, 5, 64, 160))  # classes layout, (B, C, H, W)
    mh = _maneuvers(3)
    jmodel = jnet.TinycarCombo()
    x = jnet.pre_obs(jnp.asarray(frames))
    variables = jax.tree_util.tree_map(
        np.asarray, jmodel.init(jax.random.key(0), x, jnp.asarray(mh)))
    # nonzero running statistics, so BatchNorm's eval path is exercised
    rng = np.random.default_rng(2)
    for blk in variables["batch_stats"]["encoder"].values():
        bn = blk["BatchNorm_0"]
        bn["mean"] = rng.normal(0, 0.1, bn["mean"].shape).astype(np.float32)
        bn["var"] = rng.uniform(0.5, 2, bn["var"].shape).astype(np.float32)
    sd = convert.combo_state_dict_from_flax(variables)
    model = pnet.TinycarCombo(in_channels=5, flat_features=64 * 2 * 5)
    model.load_state_dict(sd)
    model.eval()
    out = np.asarray(jmodel.apply(variables, x, jnp.asarray(mh)))
    with torch.no_grad():
        got = model(pnet.pre_obs(torch.from_numpy(frames)),
                    torch.from_numpy(mh)).numpy()
    np.testing.assert_allclose(got, out, rtol=0, atol=1e-5)


@pytest.mark.parametrize("shape,dtype", [
    ((2, 12, 20, 3), np.uint8),    # rgb, (B, H, W, 3)
    ((2, 3, 12, 20), np.uint8),    # rgb_planar, (B, 3, H, W)
    ((2, 5, 12, 20), np.uint8),    # classes, (B, L, H, W)
    ((2, 5, 12, 20), np.float32),  # float 0/1 masks: only the layout moves
])
def test_pre_obs_layouts(shape, dtype):
    """pre_obs gives NCHW float32 in [0, 1]: the JAX package's NHWC output,
    channels moved first."""
    rng = np.random.default_rng(4)
    obs = (rng.integers(0, 256, shape).astype(np.uint8) if dtype == np.uint8
           else (rng.random(shape) < 0.5).astype(np.float32))
    got = pnet.pre_obs(torch.from_numpy(obs))
    want = np.moveaxis(np.asarray(jnet.pre_obs(jnp.asarray(obs))), -1, 1)
    assert got.dtype == torch.float32 and got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), want.astype(np.float32))


def test_pre_obs_rank():
    """A (B, H, W) rank map raises in pre_obs (the JAX version would treat
    B as channels) and decodes in pre_obs_rank to the JAX one-hot, NCHW."""
    rank = np.random.default_rng(5).integers(0, 6, (2, 12, 20)).astype(
        np.uint8)
    with pytest.raises(ValueError, match="pre_obs_rank"):
        pnet.pre_obs(torch.from_numpy(rank))
    got = pnet.pre_obs_rank(torch.from_numpy(rank), 5)
    want = np.moveaxis(np.asarray(jnet.pre_obs_rank(jnp.asarray(rank), 5)),
                       -1, 1)
    assert got.dtype == torch.float32 and got.shape == (2, 5, 12, 20)
    np.testing.assert_array_equal(got.numpy(), want)


def test_load_pretrained_catalog(capsys):
    """The bundled combo for (3, 128, 160) and the rgb observation shape
    (128, 160, 3); None with the JAX package's message otherwise."""
    a = pnet.load_pretrained((128, 160, 3), device="cpu")
    b = pnet.load_pretrained((3, 128, 160), device="cpu")
    for ta, tb in zip(a.state_dict().values(), b.state_dict().values()):
        assert torch.equal(ta, tb)
    assert pnet.load_pretrained((5, 128, 160), device="cpu") is None
    assert pnet.load_pretrained((3, 128, 160), maneuver_dim=4,
                                device="cpu") is None
    out = capsys.readouterr().out
    assert "loaded bundled pretrained combo" in out
    assert "No pretrained weights found for image_dim: (5, 128, 160)" in out
    assert pnet.FEATURE_VEC_SIZE == jnet.FEATURE_VEC_SIZE
