from mapfree_tpu_torch.geom.quaternion import (
    axangle2quat,
    convert_world2cam_to_cam2world,
    euler2quat,
    mat2quat,
    qconjugate,
    qinverse,
    qmult,
    quat2mat,
    relative_pose_wxyz,
    rotate_vector,
)
from mapfree_tpu_torch.geom.rotation import (
    euler_xyz_to_matrix,
    inv_rodrigues,
    matrix_to_euler_xyz,
    rodrigues,
    rotation_matrix_from_ortho6d,
)
from mapfree_tpu_torch.geom.procrustes import procrustes
from mapfree_tpu_torch.geom.projection import backproject_3d, correct_intrinsic_scale, project
