import jax.numpy as jnp
import numpy as np
import pytest

from multi_orbslam3_jax import config as cfg
from multi_orbslam3_jax.dataio import synthetic
from multi_orbslam3_jax.frontend import extractor, fast, matcher, orb


@pytest.fixture(scope="module")
def small_config():
    c = cfg.synthetic_mono(width=320, height=240)
    return c.replace(orb=cfg.ORBConfig(n_features=256, n_levels=4))


@pytest.fixture(scope="module")
def seq(small_config):
    return synthetic.make_sequence(small_config, n_frames=3, n_points=200, seed=3)


class TestFast:
    def test_detects_synthetic_corner(self):
        img = jnp.zeros((64, 64), jnp.float32)
        img = img.at[20:40, 20:40].set(200.0)
        s = fast.fast_score(img, 20.0)
        # corners of the bright square should respond
        assert float(jnp.max(s)) > 20.0
        sn = fast.nms3x3(s)
        n_peaks = int(jnp.sum(sn > 0))
        assert 1 <= n_peaks <= 12

    def test_flat_image_no_corners(self):
        img = jnp.full((64, 64), 100.0, jnp.float32)
        s = fast.fast_score(img, 7.0)
        assert float(jnp.max(s)) == 0.0

    def test_score_is_max_threshold(self):
        img = jnp.zeros((32, 32), jnp.float32)
        img = img.at[10:22, 10:22].set(50.0)
        s_lo = fast.fast_score(img, 7.0)
        s_hi = fast.fast_score(img, 45.0)
        # high threshold keeps only pixels whose low-threshold score exceeds it
        np.testing.assert_array_equal(np.asarray(s_hi > 0),
                                      np.asarray(s_lo > 45.0))


class TestExtractor:
    def test_extract_shapes_and_validity(self, small_config, seq):
        feats = extractor.extract_features(jnp.asarray(seq.images[0]), small_config)
        n = small_config.orb.n_features
        assert feats.uv.shape == (n, 2)
        assert feats.desc.shape == (n, 8) and feats.desc.dtype == jnp.uint32
        n_valid = int(jnp.sum(feats.valid))
        assert n_valid > 50, f"only {n_valid} features detected"

    def test_keypoints_near_landmarks(self, small_config, seq):
        feats = extractor.extract_features(jnp.asarray(seq.images[0]), small_config)
        K = np.array([[small_config.camera.fx, 0, small_config.camera.cx],
                      [0, small_config.camera.fy, small_config.camera.cy],
                      [0, 0, 1.0]])
        pc = seq.points @ seq.T_cw[0, :3, :3].T + seq.T_cw[0, :3, 3]
        vis = pc[:, 2] > 0.3
        uv_gt = (pc[:, :2] / pc[:, 2:3]) @ K[:2, :2].T + K[:2, 2]
        uv_gt = uv_gt[vis]
        uv = np.asarray(feats.uv)[np.asarray(feats.valid)]
        # each detected keypoint should be within a few px of some landmark
        # landmarks render as 9x9 textured patches — corners can fire anywhere
        # inside, so "near" means within the patch half-diagonal (~6.4 px)
        # plus coarse-level quantization.
        d = np.linalg.norm(uv[:, None, :] - uv_gt[None, :, :], axis=-1).min(axis=1)
        frac_close = float((d < 8.0).mean())
        assert frac_close > 0.6, f"only {frac_close:.2f} keypoints near landmarks"

    def test_descriptors_match_across_frames(self, small_config, seq):
        f0 = extractor.extract_features(jnp.asarray(seq.images[0]), small_config)
        f1 = extractor.extract_features(jnp.asarray(seq.images[1]), small_config)
        res = matcher.match_mutual(f0.desc, f0.valid, f1.desc, f1.valid,
                                   max_dist=matcher.TH_LOW, ratio=0.9,
                                   angle1=f0.angle, angle2=f1.angle)
        n_matches = int(res.count)
        assert n_matches > 30, f"only {n_matches} mutual matches between frames"


class TestMatcher:
    def test_hamming_identity(self):
        d = jnp.asarray(np.random.RandomState(0).randint(
            0, 2**32, (16, 8), dtype=np.uint32))
        H = matcher.hamming_matrix(d, d)
        np.testing.assert_array_equal(np.asarray(jnp.diagonal(H)), 0)

    def test_hamming_known_distance(self):
        a = jnp.zeros((1, 8), jnp.uint32)
        b = jnp.full((1, 8), 1, jnp.uint32)  # one bit set per word
        assert int(matcher.hamming_matrix(a, b)[0, 0]) == 8

    def test_mutual_match_exact(self):
        rng = np.random.RandomState(1)
        d1 = jnp.asarray(rng.randint(0, 2**32, (32, 8), dtype=np.uint32))
        perm = rng.permutation(32)
        d2 = d1[perm]
        valid = jnp.ones(32, bool)
        res = matcher.match_mutual(d1, valid, d2, valid, max_dist=0, ratio=1.0)
        idx = np.asarray(res.idx)
        inv = np.argsort(perm)
        np.testing.assert_array_equal(idx, inv)

    def test_projection_radius_mask(self):
        rng = np.random.RandomState(2)
        d = jnp.asarray(rng.randint(0, 2**32, (8, 8), dtype=np.uint32))
        feat_uv = jnp.asarray(rng.uniform(0, 100, (8, 2)).astype(np.float32))
        # project each point exactly at its feature, tiny radius
        res = matcher.match_by_projection(
            feat_uv, jnp.ones(8, bool), d, feat_uv, jnp.ones(8, bool), d,
            jnp.zeros(8, jnp.int32), radius=2.0,
            pred_level=jnp.zeros(8, jnp.int32))
        np.testing.assert_array_equal(np.asarray(res.idx), np.arange(8))

    def test_duplicate_resolution(self):
        idx = jnp.asarray([2, 2, 3, -1], jnp.int32)
        dist = jnp.asarray([10, 5, 7, matcher.BIG], jnp.int32)
        res = matcher.resolve_duplicate_targets(
            matcher.MatchResult(idx, dist), n_targets=8)
        out = np.asarray(res.idx)
        assert out[0] == -1 and out[1] == 2 and out[2] == 3 and out[3] == -1

    def test_rotation_consistency(self):
        # 60 matches at angle 0, 5 outliers at pi/2
        diffs = jnp.concatenate([jnp.zeros(60), jnp.full((5,), jnp.pi / 2)])
        valid = jnp.ones(65, bool)
        keep = matcher.rotation_consistency(diffs, valid, keep_bins=1)
        assert bool(jnp.all(keep[:60]))
        assert not bool(jnp.any(keep[60:]))


class TestOrb:
    def test_pattern_in_bounds(self):
        pat = orb.brief_pattern()
        assert pat.shape == (256, 2, 2)
        assert np.abs(pat).max() <= 13

    def test_descriptor_rotation_stability(self):
        # a descriptor computed at angle 0 should differ from angle pi/2
        # but packing must be deterministic
        img = jnp.asarray(np.random.RandomState(3).uniform(
            0, 255, (64, 64)).astype(np.float32))
        uv = jnp.asarray([[32.0, 32.0]])
        d0 = orb.compute_descriptors(img, uv, jnp.zeros(1))
        d0b = orb.compute_descriptors(img, uv, jnp.zeros(1))
        np.testing.assert_array_equal(np.asarray(d0), np.asarray(d0b))

    def test_ic_angle_gradient_direction(self):
        # bright on +x side => centroid along +x => angle ~ 0
        img = jnp.zeros((64, 64), jnp.float32)
        img = img.at[:, 40:].set(255.0)
        ang = orb.ic_angle(img, jnp.asarray([[32.0, 32.0]]))
        assert abs(float(ang[0])) < 0.2
