"""PyTorch port, the on-device SIFT and the 2-NN ratio matcher
(mapfree_tpu_torch/ops/sift.py, ops/matching.py) against the JAX package's
(mapfree_tpu/ops/sift.py, ops/matching.py) on the same seeded numpy inputs,
on the CPU.

SIFT: seeded textures of high-contrast discs at 128x128 and 96x128, budgets
of 256 and 192 features, the JAX default of 4 octaves (the per-octave top-K
then cuts octave 0). The two frameworks' blurs sum in other orders, so the DoG
values differ in the last bits; the tolerance is stated per keypoint:
- the validity masks and the scores of every slot are equal (scores to
  1e-6: |DoG| values of order 0.1);
- the valid keypoints are at the same places, as sets (1e-3 px; the
  sub-pixel offsets divide two differences of DoG values; two scores that
  tie to round-off may take each other's slot, as they do between the card
  and the CPU in chip_smoke.py phase 14);
- a descriptor holds 256 gradient samples binned by orientation, and a
  sample whose angle lies within round-off of a bin edge (``floor`` of an
  ``atan2``) lands in the neighbouring bin in one of the two (one entry
  moves), or the 36-bin orientation histogram's argmax flips on a near tie
  (the whole descriptor turns by 10 degrees: 0.61 in L2 once in 1,734
  keypoints between the card and the CPU, chip_smoke.py phase 14): so at
  least 95% of the valid keypoints have every descriptor entry within
  1e-4, and the others are not compared.
Masked slots are not compared: ``torch.topk`` and ``lax.top_k`` order tied
scores (the zero scores that pad an octave) differently.

The matcher: equal indices and masks on descriptors with masked slots,
a ratio test that rejects some rows, and fewer valid descriptors than two in
one pair; and the port's device-side padding and depth gather against the
host functions they replace."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mapfree_tpu.models.matching import pad_correspondences as jax_pad
from mapfree_tpu.ops import matching as jax_matching
from mapfree_tpu.ops import sift as jax_sift

from mapfree_tpu_torch.models.matching import (FeatureMatchingModel, compact_matches,
                                               gather_depth_device)
from mapfree_tpu_torch.ops import matching as pt_matching
from mapfree_tpu_torch.ops import sift as pt_sift

from torch_threads import one_torch_thread  # noqa: F401  (autouse)

KP_TOL = 1e-3
SCORE_TOL = 1e-6
DESC_ENTRY_TOL = 1e-4
DESC_EXACT_SHARE = 0.95


def same_keypoints(got, ref):
    """The valid keypoints as sets: each of ``ref`` has its own in ``got``
    within KP_TOL. Returns, for each of ``ref``, the index of its own."""
    d = np.abs(ref[:, None] - got[None]).max(-1)
    nearest = d.argmin(1)
    assert len(set(nearest.tolist())) == len(ref)
    assert d[np.arange(len(ref)), nearest].max() <= KP_TOL
    return nearest


def texture(B, H, W, seed):
    """Grey 0.5 with H*W/30 discs of radius 1.5-4 px at random grey levels."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    img = np.full((B, H, W), 0.5, np.float32)
    for b in range(B):
        for _ in range(H * W // 30):
            cy, cx, r = rng.uniform(0, H), rng.uniform(0, W), rng.uniform(1.5, 4)
            img[b][(yy - cy) ** 2 + (xx - cx) ** 2 < r * r] = rng.uniform(0, 1)
    return img


@pytest.mark.parametrize("hw, seed, num_features", [((128, 128), 0, 256), ((96, 128), 1, 192)])
def test_sift_matches_jax(hw, seed, num_features):
    gray = texture(3, *hw, seed)
    ref = {k: np.asarray(v) for k, v in jax_sift.sift_detect_describe(
        jnp.asarray(gray), num_features=num_features).items()}
    got = {k: v.numpy() for k, v in pt_sift.sift_detect_describe(
        torch.from_numpy(gray), num_features=num_features).items()}
    assert {k: v.shape for k, v in got.items()} == {k: v.shape for k, v in ref.items()}
    np.testing.assert_array_equal(got["mask"], ref["mask"])
    np.testing.assert_allclose(got["scores"], ref["scores"], rtol=0, atol=SCORE_TOL)
    n_valid = ref["mask"].sum(1)
    assert n_valid.min() >= 30  # the textures give real work
    # octave 0 has more candidates than its per-octave budget in some image:
    # the per-octave top-K cuts
    dogs0 = pt_sift._octave_responses(torch.from_numpy(gray), 4)[0][0]
    candidates = (pt_sift._extrema_scores(dogs0) > 0).flatten(1).sum(1)
    assert candidates.max() > num_features // 4 + 8
    exact, n = 0, 0
    for b in range(gray.shape[0]):
        m = ref["mask"][b]
        nearest = same_keypoints(got["keypoints"][b][m], ref["keypoints"][b][m])
        dg, dr = got["descriptors"][b][m][nearest], ref["descriptors"][b][m]
        exact += int((np.abs(dg - dr).max(-1) <= DESC_ENTRY_TOL).sum())
        n += int(m.sum())
    assert exact >= DESC_EXACT_SHARE * n, (exact, n)
    np.testing.assert_allclose(pt_sift.root_sift(torch.from_numpy(got["descriptors"])).numpy(),
                               np.asarray(jax_sift.root_sift(jnp.asarray(got["descriptors"]))),
                               rtol=0, atol=1e-6)


def test_rgb_to_gray_is_the_jax_weighting():
    rgb = np.random.default_rng(2).integers(0, 256, (2, 8, 9, 3)).astype(np.uint8)
    w = jnp.asarray([0.299, 0.587, 0.114], jnp.float32)
    ref = np.asarray(jnp.asarray(rgb).astype(jnp.float32) * (1.0 / 255.0) @ w)
    np.testing.assert_allclose(pt_sift.rgb_to_gray(torch.from_numpy(rgb)).numpy(), ref,
                               rtol=0, atol=1e-6)


def descriptors(B, N, D, seed, n_valid):
    """Unit-ish non-negative descriptors, view 1 holding noisy copies of some
    of view 0's rows (so the ratio test passes for some and fails for
    others), with the first n_valid[b] slots valid."""
    rng = np.random.default_rng(seed)
    d0 = np.abs(rng.normal(size=(B, N, D))).astype(np.float32)
    d1 = np.abs(rng.normal(size=(B, N, D))).astype(np.float32)
    perm = rng.permutation(N)
    d1[:, perm[: N // 2]] = d0[:, : N // 2] + rng.normal(0, 0.05, (B, N // 2, D))
    d0 /= np.linalg.norm(d0, axis=-1, keepdims=True)
    d1 /= np.linalg.norm(d1, axis=-1, keepdims=True)
    m0 = np.arange(N)[None] < np.asarray(n_valid)[:, None]
    m1 = np.roll(m0, 1, axis=0)
    return d0, d1, m0, m1


def test_matcher_matches_jax():
    d0, d1, m0, m1 = descriptors(3, 96, 32, seed=3, n_valid=[96, 70, 1])
    ref_idx, ref_ok = jax_matching.mutual_2nn_ratio_match(
        jnp.asarray(d0), jnp.asarray(d1), jnp.asarray(m0), jnp.asarray(m1), 0.8)
    idx, ok = pt_matching.mutual_2nn_ratio_match(
        *(torch.from_numpy(a) for a in (d0, d1, m0, m1)), 0.8)
    ref_ok = np.asarray(ref_ok)
    np.testing.assert_array_equal(ok.numpy(), ref_ok)
    np.testing.assert_array_equal(idx.numpy()[ref_ok], np.asarray(ref_idx)[ref_ok])
    # the rows that have two valid neighbours: the best index everywhere
    np.testing.assert_array_equal(idx.numpy()[:2], np.asarray(ref_idx)[:2])
    assert 0 < ref_ok.sum() < ref_ok.size and not ref_ok[~m0].any()


def test_device_padding_and_depth_gather_are_the_host_functions():
    """compact_matches lays the matches out as pad_correspondences does
    (fewer, and more, matches than max_n), and gather_depth_device reads the
    maps where the host gather reads them."""
    rng = np.random.default_rng(4)
    B, N = 3, 40
    kp0 = rng.uniform(-2, 50, (B, N, 2)).astype(np.float32)
    kp1 = rng.uniform(-2, 50, (B, N, 2)).astype(np.float32)
    ok = rng.uniform(size=(B, N)) < np.array([[0.3], [0.9], [0.0]])
    for max_n in (16, 64):
        want = jax_pad([np.concatenate([kp0[b][ok[b]], kp1[b][ok[b]]], -1) for b in range(B)],
                       max_n)
        got = compact_matches(torch.from_numpy(kp0), torch.from_numpy(kp1),
                              torch.from_numpy(ok), max_n)
        for g, w in zip(got, want):
            assert g.shape == w.shape
            np.testing.assert_array_equal(g.numpy(), w)
    depth = [rng.uniform(0.5, 5, (37, 45)).astype(np.float32) for _ in range(B)]
    np.testing.assert_array_equal(
        gather_depth_device(torch.from_numpy(np.stack(depth)), torch.from_numpy(kp0)).numpy(),
        FeatureMatchingModel._gather_depth_host(depth, kp0))
