"""The port's training preprocessing and TrivialAugment against the JAX
package on the CPU: the crop-resize against ``jax.image.scale_and_translate``
at fixed boxes, ``apply_params`` at the draws the reference's own
``preprocess_batch`` makes for a key (so both compute from the same boxes,
flips, ops and magnitudes), every TrivialAugment op at fixed magnitudes of
both signs, and the laws of the port's samplers against the reference's.

Tolerances (0-255 scale unless said): crop-resize 1e-3; each op 1e-3; the
whole pipeline 1e-4 on the normalized output, except where posterize's
truncation or solarize's threshold meets a value the two sides round apart
(at most 0.1% of the elements)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from concepthash_tpu.data import augment as jaug
from concepthash_tpu.data import preprocess as jpp
from concepthash_tpu_torch.data import augment as taug
from concepthash_tpu_torch.data import preprocess as tpp

ATOL = 1e-3


def _images(seed, b, size):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (b, size, size, 3)).astype(np.uint8)


# (top, left, h, w) on a 20-pixel image: the whole image, boxes touching each
# edge and corner, boxes under 2 pixels, and fractional ones
BOXES = [(0.0, 0.0, 20.0, 20.0), (0.0, 0.0, 5.0, 7.0), (13.5, 11.0, 6.5, 9.0),
         (0.0, 12.25, 20.0, 7.75), (3.2, 4.7, 1.0, 1.3), (18.4, 0.0, 1.6, 1.0),
         (7.3, 2.9, 11.1, 4.4), (0.6, 0.2, 19.4, 19.8)]


@pytest.mark.parametrize("out_size", [12, 20, 31])
def test_crop_resize_matches_scale_and_translate(out_size):
    """Down-scaling, same size and up-scaling boxes."""
    img = _images(0, len(BOXES), 20).astype(np.float32)
    want = np.stack([np.asarray(jpp._crop_resize_one(
        jnp.asarray(im), tuple(jnp.float32(v) for v in box), out_size))
        for im, box in zip(img, BOXES)])
    boxes = [torch.tensor(col, dtype=torch.float32) for col in zip(*BOXES)]
    got = tpp._crop_resize(torch.from_numpy(img), boxes, out_size).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_crop_resize_keeps_a_constant_image_constant():
    """The renormalized tent weights: edges do not darken."""
    img = np.full((len(BOXES), 20, 20, 3), 100.0, np.float32)
    boxes = [torch.tensor(col, dtype=torch.float32) for col in zip(*BOXES)]
    got = tpp._crop_resize(torch.from_numpy(img), boxes, 16).numpy()
    np.testing.assert_allclose(got, 100.0, atol=ATOL)


def _jax_params(key, b, in_size, crop, augment):
    """The draws jax's preprocess_batch makes for ``key``, as port params."""
    k_box, k_flip, k_aug = jax.random.split(key, 3)
    params = {}
    if augment in ("rrc", "trivial", "simple", "trivialaugment"):
        params["boxes"] = [torch.from_numpy(np.array(t)) for t in
                           jpp._sample_rrc_params(k_box, b, in_size)]
    elif augment == "randcrop":
        top = jax.random.randint(k_box, (b,), 0, in_size - crop + 1)
        left = jax.random.randint(jax.random.fold_in(k_box, 1), (b,), 0,
                                  in_size - crop + 1)
        params["corner"] = (torch.from_numpy(np.array(top)).long(),
                            torch.from_numpy(np.array(left)).long())
    params["flip"] = torch.from_numpy(np.array(
        jax.random.bernoulli(k_flip, 0.5, (b,))))
    if augment in ("trivial", "trivialaugment"):
        k_op, k_mag, k_sign = jax.random.split(k_aug, 3)
        op = jax.random.randint(k_op, (b,), 0, len(jaug._OPS))
        mag = jax.random.uniform(k_mag, (b,))
        sign = jnp.where(jax.random.bernoulli(k_sign, 0.5, (b,)), 1.0, -1.0)
        params["op"] = torch.from_numpy(np.array(op)).long()
        params["magnitude"] = torch.from_numpy(np.array(mag * sign))
    return params


@pytest.mark.parametrize("augment", ["rrc", "simple", "trivial",
                                     "trivialaugment", "randcrop", None])
def test_preprocess_batch_at_the_reference_draws(augment):
    b, size, crop = 28, 24, 16
    img = _images(1, b, size)
    key = jax.random.PRNGKey(5)
    want = np.asarray(jpp.preprocess_batch(jnp.asarray(img), key, crop=crop,
                                           norm=3, train=True,
                                           augment=augment))
    params = _jax_params(key, b, size, crop, augment)
    if "op" in params:     # the draw covers many ops
        assert len(set(params["op"].tolist())) >= 10
    got = tpp.apply_params(torch.from_numpy(img), params, crop=crop,
                           norm=3).numpy()
    assert got.shape == want.shape == (b, crop, crop, 3)
    far = np.abs(got - want) > 1e-4
    assert far.mean() <= (1e-3 if "op" in params else 0.0), far.mean()


def test_preprocess_eval_is_center_crop():
    img = _images(2, 3, 24)
    want = np.asarray(jpp.preprocess_batch(jnp.asarray(img),
                                           jax.random.PRNGKey(0), crop=16,
                                           norm=2, train=False))
    got = tpp.preprocess_batch(torch.from_numpy(img), crop=16, norm=2,
                               train=False).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_preprocess_batch_draws_from_its_generators():
    """The same generators repeat the batch; every branch keeps the shape."""
    img = torch.from_numpy(_images(3, 6, 24))
    for augment in ("rrc", "trivial", "randcrop", None):
        outs = [tpp.preprocess_batch(
            img, torch.Generator().manual_seed(4), crop=16, train=True,
            augment=augment, op_generator=torch.Generator().manual_seed(5))
            for _ in range(2)]
        assert outs[0].shape == (6, 16, 16, 3)
        assert torch.equal(outs[0], outs[1])
    with pytest.raises(ValueError, match="op_generator"):
        tpp.preprocess_batch(img, torch.Generator(), crop=16, train=True,
                             augment="trivial")


# magnitudes of both signs; 0.97 rotates and shears the corners far out
MAGS = (0.97, -0.73, 0.41, -0.18, 0.02, -0.55)


@pytest.mark.parametrize("op", range(len(jaug._OPS)))
def test_trivial_augment_op_matches_reference(op):
    rng = np.random.default_rng(op)
    # values a fraction away from an integer: posterize truncates them
    img = (rng.integers(0, 255, (len(MAGS), 18, 22, 3))
           + rng.uniform(0.05, 0.95, (len(MAGS), 18, 22, 3))).astype(
               np.float32)
    want = np.stack([np.asarray(jaug._OPS[op](jnp.asarray(im),
                                              jnp.float32(m)))
                     for im, m in zip(img, MAGS)])
    got = taug.OPS[op](torch.from_numpy(img),
                       torch.tensor(MAGS, dtype=torch.float32)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_affine_zero_pads_each_corner():
    """map_coordinates' constant mode: a translate by half a pixel off the
    edge of a constant image gives half the value there."""
    img = torch.full((1, 8, 10, 3), 100.0)
    m = torch.tensor([-0.5 / (10 * 0.3)])       # half a pixel to the left
    got = taug._translate_x(img, m)
    want = np.asarray(jaug._translate_x(jnp.full((8, 10, 3), 100.0),
                                        jnp.float32(m.item())))
    np.testing.assert_allclose(got[0].numpy(), want, atol=ATOL)
    assert abs(float(got[0, 3, 0, 0]) - 50.0) < ATOL


def test_trivial_augment_batch_groups_by_op():
    """Each image gets exactly its own op: the grouped batch equals the ops
    applied image by image."""
    rng = np.random.default_rng(7)
    b = 20
    img = torch.from_numpy(rng.uniform(0, 255, (b, 12, 12, 3)).astype(
        np.float32))
    op = torch.from_numpy(rng.integers(0, len(taug.OPS), b))
    mag = torch.from_numpy(rng.uniform(-1, 1, b).astype(np.float32))
    got = taug.trivial_augment_batch(img, op, mag)
    for i in range(b):
        want = taug.OPS[int(op[i])](img[i:i + 1], mag[i:i + 1])
        torch.testing.assert_close(got[i:i + 1], want, rtol=0, atol=0)


def test_sampler_laws_match_reference():
    """Seeded counts: area fraction and log-ratio moments of the boxes, flip
    and sign rates, op frequencies — port against reference, each within
    its stated band."""
    n, size = 20000, 64
    jt, jl, jh, jw = (np.asarray(t) for t in jpp._sample_rrc_params(
        jax.random.PRNGKey(0), n, size))
    g = torch.Generator().manual_seed(0)
    tt, tl, th, tw = (t.numpy() for t in tpp._sample_rrc_params(g, n, size))
    for top, left, h, w in ((jt, jl, jh, jw), (tt, tl, th, tw)):
        assert (h >= 1).all() and (w >= 1).all()
        assert (top >= 0).all() and (top + h <= size + 1e-3).all()
        assert (left >= 0).all() and (left + w <= size + 1e-3).all()

    def moments(h, w):
        area = h * w / size ** 2
        lr = np.log(w / h)
        return area.mean(), area.std(), lr.mean(), lr.std()

    for a, b_, band in zip(moments(jh, jw), moments(th, tw),
                           (0.01, 0.01, 0.01, 0.01)):
        assert abs(a - b_) < band, (a, b_)
    params = tpp.sample_params(n, size, 48, "trivial", g,
                               torch.Generator().manual_seed(1))
    assert abs(params["flip"].float().mean().item() - 0.5) < 0.01
    freq = np.bincount(params["op"].numpy(), minlength=14) / n
    assert np.abs(freq - 1 / 14).max() < 0.01, freq
    mag = params["magnitude"].numpy()
    assert abs((mag > 0).mean() - 0.5) < 0.01
    assert abs(np.abs(mag).mean() - 0.5) < 0.01
    assert np.abs(mag).max() < 1.0
