"""Plain PyTorch reference of the relative-pose regression models the
benchmark runs: the two-view ``Regression`` model and the multi-frame
``RegressionMultiFrameFusion`` model, with a ResUNet encoder (pre-activation
bottlenecks), the correlation-volume warping aggregator with the soft-argmax
position and the max-score channel, and the deep Procrustes head with an
added basis (Map-free Relocalization, Arnold et al., ECCV 2022;
nianticlabs/map-free-reloc ``lib/models/regression/``).

It is written from the published architecture for this folder alone and
imports nothing of the system under test. Every operation is float32 and
the caller turns TF32 off (:func:`exact_float32`). The correlation is taken
per block of pairs, so that the [HW, HW] volumes of a block fit. The
parameter names are those of the reference implementation's torch modules,
so one state dict serves both sides.

``rnd`` is the rounding applied to the operands of every convolution and of
the correlation's two products (q, k; the probabilities and [v | grid]), as
the configurations run them in bfloat16:
:func:`exact` (none) for the reference, :func:`fp8_e4m3` for the control
that stands one precision below bfloat16.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch import nn


def exact(x):
    return x


def _scaled_fp8(x, dtype, top):
    """``x`` rounded to the float8 ``dtype`` with one scale per tensor (its
    largest magnitude at ``top``, the format's largest value), in float32."""
    amax = x.abs().amax()
    scale = torch.where(amax > 0, top / amax, torch.ones_like(amax))
    return (x * scale).to(dtype).float() / scale


def fp8_e4m3(x):
    """``x`` rounded to float8 e4m3 with one scale per tensor (its largest
    magnitude at 448, e4m3's largest value), held in float32: one precision
    below bfloat16."""
    return _scaled_fp8(x, torch.float8_e4m3fn, 448.0)


ROUNDINGS = {"exact": exact, "fp8_e4m3": fp8_e4m3}


@contextlib.contextmanager
def exact_float32():
    """TF32 off for float32 matrix products and cuDNN convolutions inside
    the block; the settings are restored after it."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


# -- layers ------------------------------------------------------------------

class Conv(nn.Module):
    def __init__(self, cin, cout, k, stride=1, padding=0, bias=False):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.weight = nn.Parameter(torch.empty(cout, cin, k, k))
        self.bias = nn.Parameter(torch.empty(cout)) if bias else None

    def forward(self, x, rnd):
        return F.conv2d(rnd(x), rnd(self.weight), self.bias, self.stride, self.padding)


class BN(nn.Module):
    """Batch normalisation, eps 1e-5: the batch's statistics (biased
    variance) in training, the running ones otherwise."""

    def __init__(self, c):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(c))
        self.bias = nn.Parameter(torch.empty(c))
        self.register_buffer("running_mean", torch.empty(c))
        self.register_buffer("running_var", torch.empty(c))
        self.register_buffer("num_batches_tracked", torch.zeros((), dtype=torch.long))

    def forward(self, x):
        if self.training:
            return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, 1e-5)
        return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                            False, 0.0, 1e-5)


class Linear(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin))
        self.bias = nn.Parameter(torch.empty(cout))

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)


class Bottleneck(nn.Module):
    """Pre-activation bottleneck, expansion 4."""

    def __init__(self, cin, planes, stride):
        super().__init__()
        self.bn1, self.conv1 = BN(cin), Conv(cin, planes, 1)
        self.bn2, self.conv2 = BN(planes), Conv(planes, planes, 3, stride, 1)
        self.bn3, self.conv3 = BN(planes), Conv(planes, 4 * planes, 1)
        self.shortcut = (nn.Sequential(Conv(cin, 4 * planes, 1, stride))
                         if stride != 1 or cin != 4 * planes else None)

    def forward(self, x, rnd):
        out = F.relu(self.bn1(x))
        short = self.shortcut[0](out, rnd) if self.shortcut is not None else x
        out = self.conv1(out, rnd)
        out = self.conv2(F.relu(self.bn2(out)), rnd)
        out = self.conv3(F.relu(self.bn3(out)), rnd)
        return out + short


class Basic(nn.Module):
    """Pre-activation basic block with batch normalisation."""

    def __init__(self, cin, planes, stride):
        super().__init__()
        self.bn1, self.conv1 = BN(cin), Conv(cin, planes, 3, stride, 1)
        self.bn2, self.conv2 = BN(planes), Conv(planes, planes, 3, 1, 1)
        self.shortcut = (nn.Sequential(Conv(cin, planes, 1, stride))
                         if stride != 1 or cin != planes else None)

    def forward(self, x, rnd):
        out = F.relu(self.bn1(x))
        short = self.shortcut[0](out, rnd) if self.shortcut is not None else x
        out = self.conv1(out, rnd)
        return self.conv2(F.relu(self.bn2(out)), rnd) + short


class ConvBnElu(nn.Module):
    def __init__(self, cin, cout, k):
        super().__init__()
        self.conv = Conv(cin, cout, k, 1, (k - 1) // 2, bias=True)
        self.normalize = BN(cout)

    def forward(self, x, rnd):
        return F.elu(self.normalize(self.conv(x, rnd)))


class UpConv(nn.Module):
    """2x bilinear upsample (align_corners) and a 3x3 ConvBnElu."""

    def __init__(self, cin, cout):
        super().__init__()
        self.conv1 = ConvBnElu(cin, cout, 3)

    def forward(self, x, rnd):
        H, W = x.shape[-2:]
        x = F.interpolate(x, size=(2 * H, 2 * W), mode="bilinear", align_corners=True)
        return self.conv1(x, rnd)


def _stage(cin, planes, n, stride):
    blocks = []
    for i in range(n):
        blocks.append(Bottleneck(cin, planes, stride if i == 0 else 1))
        cin = 4 * planes
    return nn.Sequential(*blocks)


def _skip_concat(y, skip):
    """Pad (or crop) the skip to y's size, centred (the extra row or column
    at the end), and concatenate [y, skip] on channels."""
    pads = []
    for axis in (3, 2):
        d = y.shape[axis] - skip.shape[axis]
        pads += [d // 2, d - d // 2]
    return torch.cat([y, F.pad(skip, pads)], dim=1)


class ResUNet(nn.Module):
    def __init__(self, num_blocks, out_channels):
        super().__init__()
        self.firstconv, self.firstbn = Conv(3, 64, 7, 2, 3), BN(64)
        self.encoder1 = _stage(64, 64, num_blocks[0], 1)
        self.encoder2 = _stage(256, 128, num_blocks[1], 2)
        self.encoder3 = _stage(512, 256, num_blocks[2], 2)
        self.upconv4, self.iconv4 = UpConv(1024, 512), ConvBnElu(512 + 512, 512, 3)
        self.upconv3, self.iconv3 = UpConv(512, 256), ConvBnElu(256 + 256, 256, 3)
        self.outconv = ConvBnElu(256, out_channels, 1)

    def forward(self, x, rnd):
        """x: float32 RGB [N, 3, H, W] in [0, 1] -> [N, C, H/4, W/4]."""
        x = F.max_pool2d(F.relu(self.firstbn(self.firstconv(x, rnd))), 3, 2, padding=1)
        feats = []
        for stage in (self.encoder1, self.encoder2, self.encoder3):
            for block in stage:
                x = block(x, rnd)
            feats.append(x)
        x2, x3, x4 = feats
        y = self.iconv4(_skip_concat(self.upconv4(x4, rnd), x3), rnd)
        y = self.iconv3(_skip_concat(self.upconv3(y, rnd), x2), rnd)
        return self.outconv(y, rnd)


class ProcrustesHead(nn.Module):
    """Four stride-2 basic blocks (64-128-256-512), global average pool, a
    256-128-(3 * points) MLP in float32, then a Kabsch solve between the
    two halves of the anchors, each plus the identity basis."""

    def __init__(self, cin, points=6):
        super().__init__()
        for i, planes in enumerate((64, 128, 256, 512), start=1):
            setattr(self, f"resblock{i}", Basic(cin, planes, 2))
            cin = planes
        self.mlp = nn.Sequential(Linear(512, 256), nn.ReLU(), Linear(256, 128), nn.ReLU(),
                                 Linear(128, 3 * points))

    def forward(self, x, rnd):
        for i in range(1, 5):
            x = getattr(self, f"resblock{i}")(x, rnd)
        anchors = self.mlp(x.mean(dim=(2, 3))).reshape(x.shape[0], -1, 3)
        n = anchors.shape[1] // 2
        basis = torch.eye(3, device=x.device)
        return kabsch(anchors[:, :n] + basis, anchors[:, n:] + basis)


def kabsch(A, B):
    """R, t minimising ||A R^T + t - B|| over rotations: [N, 3, 3], [N, 1, 3]."""
    a_mean, b_mean = A.mean(dim=1, keepdim=True), B.mean(dim=1, keepdim=True)
    H = (A - a_mean).transpose(1, 2) @ (B - b_mean)
    U, _, Vt = torch.linalg.svd(H)
    V = Vt.transpose(1, 2)
    sign = torch.sign(torch.linalg.det(V @ U.transpose(1, 2)))
    V = torch.cat([V[..., :2], V[..., 2:] * sign[:, None, None]], dim=-1)
    R = V @ U.transpose(1, 2)
    return R, b_mean - a_mean @ R.transpose(1, 2)


# -- images and correlation ----------------------------------------------------

def yuv420_to_rgb(packed):
    """Planar YUV420 uint8 [N, H*3/2, W] (Y rows, then U | V side by side at
    half resolution) -> float32 RGB [N, 3, H, W] in [0, 1]: half-pixel
    bilinear chroma upsampling and JFIF full-range YCbCr -> RGB."""
    N, H15, W = packed.shape
    H = 2 * H15 // 3
    y = packed[:, :H].float()
    uv = packed[:, H:].float() - 128.0
    uv = torch.stack([uv[..., : W // 2], uv[..., W // 2:]], dim=1)  # [N, 2, H/2, W/2]
    u, v = F.interpolate(uv, size=(H, W), mode="bilinear", align_corners=False).unbind(1)
    rgb = torch.stack([y + 1.402 * v, y - 0.344136286 * u - 0.714136286 * v, y + 1.772 * u], 1)
    return torch.clamp(rgb / 255.0, 0.0, 1.0)


def rgb_uint8(images):
    """uint8 RGB [N, H, W, 3] -> float32 [N, 3, H, W] in [0, 1]."""
    return images.permute(0, 3, 1, 2).float() / 255.0


def uv_grid(H, W, device):
    """[HW, 2]: (u over rows, v over columns) in [-1, 1], row-major."""
    u = torch.linspace(-1.0, 1.0, H, device=device)
    v = torch.linspace(-1.0, 1.0, W, device=device)
    return torch.stack([u.repeat_interleave(W), v.repeat(H)], dim=-1)


def _warp_block(q, k, vg, rnd):
    p = torch.softmax(q @ k.transpose(1, 2), dim=-1)
    return torch.cat([rnd(p) @ vg, p.amax(dim=-1, keepdim=True)], dim=-1)


def correlate(vol0, vol1, rnd, block=8):
    """Correlation-volume warping of [N, C, h, w] volumes: per position of
    view 0 a softmax over view 1's positions of the feature products warps
    view 1's features and the uv grid; returns [N, 2C + 3, h, w] =
    [view 0 | warped | soft-argmax position | max probability]. ``block``
    pairs at a time."""
    N, C, h, w = vol0.shape
    f0 = vol0.flatten(2).transpose(1, 2)
    f1 = vol1.flatten(2).transpose(1, 2)
    grid = uv_grid(h, w, vol0.device).expand(N, h * w, 2)
    q, k, vg = rnd(f0), rnd(f1), rnd(torch.cat([f1, grid], dim=-1))
    outs = []
    for i in range(0, N, block):
        outs.append(_warp_block(q[i:i + block], k[i:i + block], vg[i:i + block], rnd))
    agg = torch.cat([f0, torch.cat(outs)], dim=-1)
    return agg.transpose(1, 2).reshape(N, 2 * C + 3, h, w)


# -- the models ------------------------------------------------------------------

def quat2mat(q):
    """Quaternions [..., 4] (w, x, y, z), normalised first -> [..., 3, 3]."""
    w, x, y, z = (q / torch.linalg.norm(q, dim=-1, keepdim=True)).unbind(-1)
    return torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w),
        2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w),
        2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y),
    ], dim=-1).reshape(q.shape[:-1] + (3, 3))


def mat2quat(R):
    """Rotations [..., 3, 3] -> unit quaternions [..., 4], up to sign: from
    the largest of the four pivots 1 + tr, 1 + 2 R_ii - tr."""
    tr = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    pivots = torch.stack([1 + tr, 1 + 2 * R[..., 0, 0] - tr, 1 + 2 * R[..., 1, 1] - tr,
                          1 + 2 * R[..., 2, 2] - tr], dim=-1)
    a = R[..., 2, 1] - R[..., 1, 2]
    b = R[..., 0, 2] - R[..., 2, 0]
    c = R[..., 1, 0] - R[..., 0, 1]
    d = R[..., 0, 1] + R[..., 1, 0]
    e = R[..., 0, 2] + R[..., 2, 0]
    f = R[..., 1, 2] + R[..., 2, 1]
    s = 2 * torch.sqrt(torch.clamp(pivots, min=1e-24))
    cands = torch.stack([
        torch.stack([s[..., 0] ** 2 / 4, a, b, c], -1) / s[..., 0:1],
        torch.stack([a, s[..., 1] ** 2 / 4, d, e], -1) / s[..., 1:2],
        torch.stack([b, d, s[..., 2] ** 2 / 4, f], -1) / s[..., 2:3],
        torch.stack([c, e, f, s[..., 3] ** 2 / 4], -1) / s[..., 3:4],
    ], dim=-2)
    choice = pivots.argmax(dim=-1)
    q = torch.take_along_dim(cands, choice[..., None, None], dim=-2)[..., 0, :]
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def fuse_poses(R_f, t_f, q_device, t_device, weights):
    """Chain each frame's estimate T_ref->f through the device tracking
    (world-to-camera) into the last frame, and fuse: the rotation by the
    weighted chordal mean of the quaternions (the top eigenvector of
    sum w q q^T), the translation by the weighted mean."""
    R_dev = quat2mat(q_device)
    R_rel = R_dev[:, -1:] @ R_dev.transpose(-1, -2)
    t_rel = t_device[:, -1:] - (R_rel @ t_device[..., None])[..., 0]
    R_est = R_rel @ R_f
    t_est = (R_rel @ t_f[..., None])[..., 0] + t_rel
    q = mat2quat(R_est)
    M = torch.einsum("bf,bfi,bfj->bij", weights, q, q)
    R = quat2mat(torch.linalg.eigh(M)[1][..., -1])
    return R, torch.einsum("bf,bfi->bi", weights, t_est)


class Model(nn.Module):
    """``Regression`` (``frames`` 0) or ``RegressionMultiFrameFusion``
    (``frames`` F > 0: a window of F query frames with device poses)."""

    def __init__(self, num_blocks=(3, 3, 3), channels=32, points=6, frames=0):
        super().__init__()
        self.frames = frames
        self.encoder = ResUNet(num_blocks, channels)
        self.head = ProcrustesHead(2 * channels + 3, points)
        if frames:
            self.frame_weight = Linear(2 * channels + 3, 1)

    def encode(self, images, rnd, chunk=None):
        """Volumes of float32 RGB [N, 3, H, W]; without batch statistics
        (evaluation) ``chunk`` images at a time."""
        if chunk is None or self.training:
            return self.encoder(images, rnd)
        return torch.cat([self.encoder(images[i:i + chunk], rnd)
                          for i in range(0, images.shape[0], chunk)])

    def forward(self, image0, image1, ref_idx=None, q_device=None, t_device=None,
                rnd=exact, chunk=None):
        """Float32 RGB images [N, 3, H, W]. Two-view: image0 holds the
        unique references, ``ref_idx`` [B] each pair's; fusion: image0
        [B, ...] and image1 [B * F, ...] frame-major within each window.
        Returns R [B, 3, 3], t [B, 1, 3]."""
        U = image0.shape[0]
        vols = self.encode(torch.cat([image0, image1]), rnd, chunk)
        vol0, vol1 = vols[:U], vols[U:]
        if self.frames:
            vol0 = vol0.repeat_interleave(self.frames, dim=0)
        elif ref_idx is not None:
            vol0 = vol0[ref_idx]
        agg = correlate(vol0, vol1, rnd)
        R, t = self.head(agg, rnd)
        if not self.frames:
            return R, t
        B, F_ = U, self.frames
        w = torch.softmax(self.frame_weight(rnd(agg).mean(dim=(2, 3))).reshape(B, F_), -1)
        R, t = fuse_poses(R.reshape(B, F_, 3, 3), t.reshape(B, F_, 3), q_device, t_device, w)
        return R, t.reshape(B, 1, 3)


# what this reference implements, as a configuration's settings name it
IMPLEMENTS = {
    "ENCODER.TYPE": "ResUNet", "ENCODER.BLOCK_TYPE": 1, "ENCODER.NOT_CONCAT": False,
    "AGGREGATOR.TYPE": "CorrelationVolumeWarping", "AGGREGATOR.POSITION_ENCODER": True,
    "AGGREGATOR.MAX_SCORE_CHANNEL": True, "AGGREGATOR.POSITION_ENCODER_IM1": None,
    "AGGREGATOR.NORMALISE_DOT": False, "AGGREGATOR.CV_OUTLAYERS": 0,
    "AGGREGATOR.CV_HALF_CHANNELS": False, "AGGREGATOR.UPSAMPLE_POS_ENC": 0,
    "AGGREGATOR.DUSTBIN": False, "HEAD.TYPE": "ProcrustesDeepResBlock", "HEAD.ADD_BASIS": True,
    "HEAD.AVG_POOL": True, "HEAD.BATCH_NORM": True, "HEAD.NUM_PTS": 6,
    "DATASET.BLACK_WHITE": False,
}
MODELS = ("Regression", "RegressionMultiFrameFusion")


def arguments(settings: dict) -> dict:
    """:class:`Model`'s arguments for a configuration's settings (dotted
    keys), after checking that they ask for what this reference
    implements."""
    wrong = {k: settings.get(k) for k, v in IMPLEMENTS.items() if settings.get(k) != v}
    if wrong or settings.get("MODEL") not in MODELS:
        raise ValueError(f"the reference does not implement {wrong or settings.get('MODEL')}")
    fusion = settings["MODEL"] == "RegressionMultiFrameFusion"
    return {"num_blocks": tuple(int(n) for n in settings["ENCODER.NUM_BLOCKS"].split("-")),
            "channels": int(settings["ENCODER.NUM_OUT_LAYERS"]),
            "points": int(settings["HEAD.NUM_PTS"]),
            "frames": int(settings["DATASET.QUERY_FRAME_COUNT"]) if fusion else 0}
