from mapfree_tpu_torch.ops.correlation import fused_correlation_warp
from mapfree_tpu_torch.ops.essential import (
    cheirality_pose,
    decompose_E,
    essential_pose,
    essential_pose_adaptive,
    essential_pose_adaptive_async,
    essential_pose_metric,
    estimate_essential,
    metric_scale_from_depth,
    metric_scale_from_point_depths,
    normalize_keypoints,
    sampson_sq,
)
from mapfree_tpu_torch.ops.matching import mutual_2nn_ratio_match
from mapfree_tpu_torch.ops.pnp import pnp_pose
from mapfree_tpu_torch.ops.procrustes_ransac import (
    dense_cloud_from_depth,
    icp_point_to_point,
    procrustes_pose,
)
from mapfree_tpu_torch.ops.ransac import (
    best_hypothesis,
    inlier_mask,
    masked_sample_indices,
    msac_score,
)
from mapfree_tpu_torch.ops.sift import root_sift, sift_detect_describe
