from mapfree_tpu_torch.utils.submission import Pose, predict, save_submission
