"""Shared pieces of the PyTorch port's data-layer and matching tests: batch
comparison (a batch or a sample of the JAX package against the port's, key
by key), a MapFree scene whose depth maps and correspondences agree with
its poses, a matching config over it in either package's schema, and
batches of the textured room the ScanNet fixtures show."""

from pathlib import Path

import numpy as np


def assert_same_value(a, b, where):
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, where
        if a.dtype.kind in "fc":
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-6, err_msg=where)
        else:
            np.testing.assert_array_equal(a, b, err_msg=where)
    elif isinstance(a, dict):  # a sample: the same keys in the same order
        assert isinstance(b, dict) and list(a) == list(b), where
        for key in a:
            assert_same_value(a[key], b[key], f"{where}.{key}")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same_value(x, y, f"{where}[{i}]")
    else:
        assert a == b, where


def assert_same_batches(jax_batches, pt_batches):
    assert len(jax_batches) == len(pt_batches) > 0
    for n, (a, b) in enumerate(zip(jax_batches, pt_batches)):
        assert list(a) == list(b), n  # the same keys in the same order
        for key in a:
            assert_same_value(a[key], b[key], f"batch {n} {key}")


def make_consistent_scene(root, n_queries=10, H=64, W=48, seed=3, depth_suffix="gt",
                          npz_name="correspondences.npz"):
    """A MapFree scene whose depth maps and precomputed correspondences agree
    with its ground-truth poses (the idea of tests/test_integration.py's
    scene): a smooth non-planar depth surface seen from view 0, a sparse grid
    of its pixels back-projected, moved by each query's relative pose and
    projected into it. Writes ``*.{depth_suffix}.png`` depth maps (16-bit mm)
    and the NaN-padded ``npz_name`` (one row per query). Returns the poses."""
    import cv2

    from fixtures import make_scene
    from mapfree_tpu.geom import quat2mat

    poses = make_scene(root, n_queries=n_queries, img_hw=(H, W), seed=seed,
                       max_angle=0.25, t_scale=0.2)
    K = np.array([[100.0, 0, W / 2], [0, 100.0, H / 2], [0, 0, 1]], np.float32)
    uu, vv = np.meshgrid(np.arange(W), np.arange(H))
    depth0 = (2.0 + 0.4 * np.sin(uu / 5.0) + 0.3 * np.cos(vv / 4.0)).astype(np.float32)
    cv2.imwrite(str(root / f"seq0/frame_00000.{depth_suffix}.png"), (depth0 * 1000).astype(np.uint16))
    gu, gv = np.meshgrid(np.arange(4, W - 4, 3), np.arange(4, H - 4, 3))
    uv0 = np.stack([gu.reshape(-1), gv.reshape(-1)], axis=-1).astype(np.float32)
    z0 = depth0[uv0[:, 1].astype(int), uv0[:, 0].astype(int)]
    X0 = np.concatenate([uv0, np.ones_like(uv0[:, :1])], axis=1) @ np.linalg.inv(K).T * z0[:, None]
    correspondences = []
    for i in range(n_queries):
        name = f"seq1/frame_{i:05}.jpg"
        q, t = poses[name]
        X1 = X0 @ quat2mat(q).T + t
        uv1h = X1 @ K.T
        uv1 = uv1h[:, :2] / uv1h[:, 2:]
        vis = ((uv1[:, 0] >= 0) & (uv1[:, 0] < W - 1) & (uv1[:, 1] >= 0)
               & (uv1[:, 1] < H - 1) & (X1[:, 2] > 0.1))
        depth1 = np.zeros((H, W), np.float32)
        ui = np.clip(uv1[vis, 0].astype(int), 0, W - 1)
        vi = np.clip(uv1[vis, 1].astype(int), 0, H - 1)
        depth1[vi, ui] = X1[vis, 2]
        cv2.imwrite(str(root / name).replace(".jpg", f".{depth_suffix}.png"),
                    (depth1 * 1000).astype(np.uint16))
        correspondences.append(np.concatenate([uv0[vis], uv1[vis]], axis=1).astype(np.float32))
    max_n = max(len(c) for c in correspondences)
    stacked = np.full((n_queries, max_n, 4), np.nan, np.float32)
    for i, c in enumerate(correspondences):
        stacked[i, :len(c)] = c
    np.savez(root / npz_name, correspondences=stacked)
    return poses


def matching_case(tmp_path, solver, default_cfg, n_queries=20, batch=2):
    """A consistent scene (``make_consistent_scene``, 64x48, depth ``gt``)
    under ``tmp_path/val`` and a FeatureMatching config for ``solver`` in
    ``default_cfg``'s schema (either package's): precomputed ground-truth
    correspondences, file depth, float32, ``batch`` pairs a batch, 256
    hypotheses over at most 512 correspondences. Returns (cfg, poses)."""
    root = tmp_path / "val" / "s00000"
    poses = make_consistent_scene(root, n_queries=n_queries)
    c = default_cfg.clone()
    c.DATASET.DATA_SOURCE = "MapFree"
    c.DATASET.DATA_ROOT = str(tmp_path)
    c.DATASET.HEIGHT, c.DATASET.WIDTH = 64, 48
    c.DATASET.ESTIMATED_DEPTH = "gt"
    c.TRAINING.NUM_WORKERS = 1
    c.TPU.INFER_BATCH = batch
    c.TPU.COMPUTE_DTYPE = "float32"
    c.TPU.RANSAC_ITERATIONS = 256
    c.TPU.MAX_CORRESPONDENCES = 512
    c.MODEL, c.FEATURE_MATCHING, c.POSE_SOLVER = "FeatureMatching", "Precomputed", solver
    c.EMAT_RANSAC.PIX_THRESHOLD, c.EMAT_RANSAC.SCALE_THRESHOLD = 2.0, 0.1
    c.PNP.REPROJECTION_INLIER_THRESHOLD = 3.0
    c.PROCRUSTES.MAX_CORR_DIST = 0.1
    c.MATCHES_FILE_PATH = str(root / "correspondences.npz")
    return c, poses


def predictions(results):
    """{(scene, frame): (R, t, inliers)} from either package's predict."""
    from mapfree_tpu_torch.geom.quaternion import quat2mat

    return {(s, p.image_name): (quat2mat(np.asarray(p.q, np.float64)), np.asarray(p.t), p.inliers)
            for s, poses in results.items() for p in poses}


def room_module():
    """tests/data/torch_port/room.py, imported: the textured room of the
    ScanNet fixtures, rendered at any size, and trees of it."""
    import importlib.util
    import sys

    name = "torch_port_room"
    if name not in sys.modules:
        path = Path(__file__).resolve().parent / "data" / "torch_port" / "room.py"
        spec = importlib.util.spec_from_file_location(name, path)
        sys.modules[name] = module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
    return sys.modules[name]


def room_batch(W, H, pairs, n_views=4):
    """A collated matching batch of the textured room seen from
    ``room.scannet_views`` at W x H: uint8 RGB images, depth maps (lists,
    as the loader keeps them), intrinsics, and the true relative poses
    [B, 4, 4] (view i to view j of each pair (i, j))."""
    room = room_module()
    K = room.correct_intrinsic_scale(room.SCANNET_K, W / room.SCANNET_W, H / room.SCANNET_H)
    views = [room.render_view(K, R, C, W, H) for R, C in room.scannet_views(n_views)]
    w2c = []
    for R, C in room.scannet_views(n_views):
        T = np.eye(4)
        T[:3, :3], T[:3, 3] = R, C
        w2c.append(np.linalg.inv(T))
    B = len(pairs)
    return {
        "image0": np.stack([views[i][0] for i, _ in pairs]),
        "image1": np.stack([views[j][0] for _, j in pairs]),
        "depth0": [views[i][1] for i, _ in pairs],
        "depth1": [views[j][1] for _, j in pairs],
        "K_color0": np.tile(K.astype(np.float32), (B, 1, 1)),
        "K_color1": np.tile(K.astype(np.float32), (B, 1, 1)),
        "T_0to1": np.stack([w2c[j] @ np.linalg.inv(w2c[i]) for i, j in pairs]).astype(np.float32),
    }


def model_yaml(root, src, overrides):
    """A copy of the repository's config ``src`` (a path under the
    repository) in ``root``, with ``overrides`` merged: {node: {key: value}}
    updates a node, {key: value} sets a key."""
    import yaml

    cfg = yaml.safe_load((Path(__file__).resolve().parents[1] / src).read_text())
    for node, values in overrides.items():
        if isinstance(values, dict):
            cfg.setdefault(node, {}).update(values)
        else:
            cfg[node] = values
    path = Path(root) / Path(src).name
    path.write_text(yaml.safe_dump(cfg))
    return path
