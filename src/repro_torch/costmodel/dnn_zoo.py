"""Layer graphs for the Table II workload models.

Each builder returns ``List[LayerSpec]`` — the per-layer workload sequence
the scheduler treats as a chain of non-preemptive jobs (paper Sec. IV:
"Each layer takes its previous layer's output as input").

Fidelity note (recorded in DESIGN.md): these are *shape-accurate
reconstructions* from the cited papers (VGG11, ResNet50, MobileNetV2-SSD,
InceptionV3, Swin-Tiny are exact up to head details; FBNet-C, Hand S/P,
Sp2Dense and PlaneRCNN are faithful approximations of the published
architectures at the layer-shape level).  The Terastal algorithms consume
only the (latency table, deadline, accuracy profile) triple, so what
matters is a realistic mix of WS- and OS-preferred layers at realistic
scale — which these provide.

``redundancy`` is the architectural-redundancy factor used by the accuracy
model (paper Fig. 4: ResNet50 / Swin-Tiny / Sp2Dense "remain robust under
multiple variants, while models with more compact architectures are more
sensitive").
"""

from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Callable, Dict, List, Optional

from repro_torch.costmodel.layers import LayerKind, LayerSpec, conv, dwconv, eltwise, fc, matmul, pool

if TYPE_CHECKING:  # runtime import is lazy (repro_torch.core pulls in this module)
    from repro_torch.core.dag import LayerDag


@dataclasses.dataclass(frozen=True)
class DnnModel:
    name: str
    layers: List[LayerSpec]
    redundancy: float  # in (0, 1]; higher = more robust to variants
    task: str = "classification"  # metric family for accuracy reporting
    baseline_accuracy: float = 0.75  # task metric of the unmodified model
    #: layer precedence DAG (None = the default linear chain).  When set,
    #: ``layers[i]`` is node ``i`` of the DAG and ``build_model_plan``
    #: distributes budgets over its critical path instead of the chain sum.
    dag: Optional[LayerDag] = None

    @property
    def n_layers(self) -> int:
        return len(self.layers)

    @property
    def total_weights(self) -> int:
        return sum(l.weights for l in self.layers)

    @property
    def total_macs(self) -> int:
        return sum(l.macs for l in self.layers)


# ---------------------------------------------------------------- VGG11 ----


def vgg11(input_hw: int = 224) -> DnnModel:
    h = input_hw
    L: List[LayerSpec] = []
    cfg = [(64, 3, 1), (128, 64, 2), (256, 128, 2), (256, 256, 0),
           (512, 256, 2), (512, 512, 0), (512, 512, 2), (512, 512, 0)]
    c_in = 3
    for i, (k, c, pool_after) in enumerate(cfg):
        L.append(conv(f"conv{i+1}", k, c_in, 3, 3, h, h))
        c_in = k
        if pool_after:
            L.append(pool(f"pool{i+1}", k, h, h))
            h //= 2
    L.append(pool("pool_final", 512, h, h))
    h //= 2
    L.append(fc("fc1", 512 * h * h, 4096))
    L.append(fc("fc2", 4096, 4096))
    L.append(fc("fc3", 4096, 1000))
    return DnnModel("vgg11", L, redundancy=0.35, baseline_accuracy=0.886)  # top-5


# -------------------------------------------------------------- ResNet50 ----


def _bottleneck(L: List[LayerSpec], tag: str, c_in: int, c_mid: int, c_out: int,
                h: int, stride: int) -> int:
    L.append(conv(f"{tag}.conv1", c_mid, c_in, 1, 1, h, h))
    L.append(conv(f"{tag}.conv2", c_mid, c_mid, 3, 3, h, h, stride=stride))
    h2 = -(-h // stride)
    L.append(conv(f"{tag}.conv3", c_out, c_mid, 1, 1, h2, h2))
    if stride != 1 or c_in != c_out:
        L.append(conv(f"{tag}.down", c_out, c_in, 1, 1, h, h, stride=stride))
    L.append(eltwise(f"{tag}.add", c_out, h2, h2))
    return h2


def resnet50(input_hw: int = 224) -> DnnModel:
    L: List[LayerSpec] = []
    h = input_hw
    L.append(conv("stem", 64, 3, 7, 7, h, h, stride=2))
    h //= 2
    L.append(pool("maxpool", 64, h, h))
    h //= 2
    c_in = 64
    for s, (n_blocks, c_mid, c_out, stride) in enumerate(
        [(3, 64, 256, 1), (4, 128, 512, 2), (6, 256, 1024, 2), (3, 512, 2048, 2)]
    ):
        for b in range(n_blocks):
            st = stride if b == 0 else 1
            h = _bottleneck(L, f"s{s+1}b{b+1}", c_in, c_mid, c_out, h, st)
            c_in = c_out
    L.append(pool("gap", 2048, h, h, R=h, S=h, stride=h))
    L.append(fc("fc", 2048, 1000))
    return DnnModel("resnet50", L, redundancy=0.85, baseline_accuracy=0.929)  # top-5


# -------------------------------------------------- MobileNetV2 (+SSD) ----


def _inverted_residual(L: List[LayerSpec], tag: str, c_in: int, c_out: int,
                       h: int, stride: int, expand: int) -> int:
    c_mid = c_in * expand
    if expand != 1:
        L.append(conv(f"{tag}.pw", c_mid, c_in, 1, 1, h, h))
    L.append(dwconv(f"{tag}.dw", c_mid, 3, 3, h, h, stride=stride))
    h2 = -(-h // stride)
    L.append(conv(f"{tag}.pwl", c_out, c_mid, 1, 1, h2, h2))
    if stride == 1 and c_in == c_out:
        L.append(eltwise(f"{tag}.add", c_out, h2, h2))
    return h2


def mobilenetv2_ssd(input_hw: int = 300) -> DnnModel:
    L: List[LayerSpec] = []
    h = input_hw
    L.append(conv("stem", 32, 3, 3, 3, h, h, stride=2))
    h = -(-h // 2)
    c_in = 32
    cfg = [(1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
           (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1)]
    blk = 0
    feat19 = None  # SSD taps the 19x19 expansion
    for t, c, n, s in cfg:
        for i in range(n):
            st = s if i == 0 else 1
            h = _inverted_residual(L, f"b{blk}", c_in, c, h, st, t)
            c_in = c
            blk += 1
    L.append(conv("head", 1280, 320, 1, 1, h, h))
    # SSDLite extra feature layers + per-scale box/class predictors.
    extras = [(512, 2), (256, 2), (256, 2), (128, 2)]
    c_e = 1280
    he = h
    for i, (c, s) in enumerate(extras):
        L.append(conv(f"extra{i}.pw", c // 2, c_e, 1, 1, he, he))
        L.append(dwconv(f"extra{i}.dw", c // 2, 3, 3, he, he, stride=s))
        he = -(-he // s)
        L.append(conv(f"extra{i}.pwl", c, c // 2, 1, 1, he, he))
        c_e = c
    # predictors: (feature hw, channels) — 19x19 tap uses the b13 expansion (576).
    for i, (fh, c) in enumerate([(19, 576), (10, 1280), (5, 512), (3, 256), (2, 256), (1, 128)]):
        L.append(dwconv(f"pred{i}.dw", c, 3, 3, fh, fh))
        L.append(conv(f"pred{i}.box", 6 * 4, c, 1, 1, fh, fh))
        L.append(conv(f"pred{i}.cls", 6 * 21, c, 1, 1, fh, fh))
    return DnnModel("mobilenetv2_ssd", L, redundancy=0.55, task="detection",
                    baseline_accuracy=0.722)  # VOC mAP


# ------------------------------------------------------------ InceptionV3 ----


def inceptionv3(input_hw: int = 299) -> DnnModel:
    L: List[LayerSpec] = []
    h = input_hw

    def cv(tag, k, c, r, s, hh, stride=1, pad="same"):
        L.append(LayerSpec(kind=LayerKind.CONV, name=tag, K=k, C=c,
                           R=r, S=s, H=hh, W=hh, stride=stride, pad=pad))

    # stem
    cv("stem1", 32, 3, 3, 3, h, 2); h = -(-h // 2)
    cv("stem2", 32, 32, 3, 3, h)
    cv("stem3", 64, 32, 3, 3, h)
    L.append(pool("stem_pool", 64, h, h)); h //= 2
    cv("stem4", 80, 64, 1, 1, h)
    cv("stem5", 192, 80, 3, 3, h)
    L.append(pool("stem_pool2", 192, h, h)); h //= 2  # 35x35x192 (for 299 input)
    c_in = 192
    # 3x InceptionA
    for i, cpool in enumerate([32, 64, 64]):
        cv(f"A{i}.b1", 64, c_in, 1, 1, h)
        cv(f"A{i}.b5a", 48, c_in, 1, 1, h); cv(f"A{i}.b5b", 64, 48, 5, 5, h)
        cv(f"A{i}.b3a", 64, c_in, 1, 1, h); cv(f"A{i}.b3b", 96, 64, 3, 3, h)
        cv(f"A{i}.b3c", 96, 96, 3, 3, h)
        cv(f"A{i}.bp", cpool, c_in, 1, 1, h)
        c_in = 64 + 64 + 96 + cpool
    # ReductionA
    cv("RA.b3", 384, c_in, 3, 3, h, 2)
    cv("RA.d1", 64, c_in, 1, 1, h); cv("RA.d2", 96, 64, 3, 3, h)
    cv("RA.d3", 96, 96, 3, 3, h, 2)
    L.append(pool("RA.pool", c_in, h, h)); h = -(-h // 2)
    c_in = 384 + 96 + c_in  # 768
    # 4x InceptionB (7x7 factorized)
    for i, c7 in enumerate([128, 160, 160, 192]):
        cv(f"B{i}.b1", 192, c_in, 1, 1, h)
        cv(f"B{i}.s1", c7, c_in, 1, 1, h); cv(f"B{i}.s2", c7, c7, 1, 7, h)
        cv(f"B{i}.s3", 192, c7, 7, 1, h)
        cv(f"B{i}.d1", c7, c_in, 1, 1, h); cv(f"B{i}.d2", c7, c7, 7, 1, h)
        cv(f"B{i}.d3", c7, c7, 1, 7, h); cv(f"B{i}.d4", c7, c7, 7, 1, h)
        cv(f"B{i}.d5", 192, c7, 1, 7, h)
        cv(f"B{i}.bp", 192, c_in, 1, 1, h)
        c_in = 768
    # ReductionB
    cv("RB.s1", 192, c_in, 1, 1, h); cv("RB.s2", 320, 192, 3, 3, h, 2)
    cv("RB.d1", 192, c_in, 1, 1, h); cv("RB.d2", 192, 192, 1, 7, h)
    cv("RB.d3", 192, 192, 7, 1, h); cv("RB.d4", 192, 192, 3, 3, h, 2)
    L.append(pool("RB.pool", c_in, h, h)); h = -(-h // 2)
    c_in = 320 + 192 + 768  # 1280
    # 2x InceptionC
    for i in range(2):
        cv(f"C{i}.b1", 320, c_in, 1, 1, h)
        cv(f"C{i}.e1", 384, c_in, 1, 1, h); cv(f"C{i}.e2a", 384, 384, 1, 3, h)
        cv(f"C{i}.e2b", 384, 384, 3, 1, h)
        cv(f"C{i}.d1", 448, c_in, 1, 1, h); cv(f"C{i}.d2", 384, 448, 3, 3, h)
        cv(f"C{i}.d3a", 384, 384, 1, 3, h); cv(f"C{i}.d3b", 384, 384, 3, 1, h)
        cv(f"C{i}.bp", 192, c_in, 1, 1, h)
        c_in = 320 + 768 + 768 + 192  # 2048
    L.append(pool("gap", 2048, h, h, R=h, S=h, stride=h))
    L.append(fc("fc", 2048, 1000))
    return DnnModel("inceptionv3", L, redundancy=0.7, baseline_accuracy=0.937)


# -------------------------------------------------------------- Swin-Tiny ----


def swin_tiny(input_hw: int = 224) -> DnnModel:
    L: List[LayerSpec] = []
    L.append(conv("patch_embed", 96, 3, 4, 4, input_hw, input_hw, stride=4))
    n = (input_hw // 4) ** 2  # tokens
    dims = [96, 192, 384, 768]
    depths = [2, 2, 6, 2]
    win = 49  # 7x7 windows
    for s, (d, depth) in enumerate(zip(dims, depths)):
        for b in range(depth):
            t = f"s{s}b{b}"
            L.append(matmul(f"{t}.qkv", n, 3 * d, d))
            L.append(matmul(f"{t}.attn_qk", n, win, d))
            L.append(matmul(f"{t}.attn_v", n, d, win))
            L.append(matmul(f"{t}.proj", n, d, d))
            L.append(matmul(f"{t}.mlp1", n, 4 * d, d))
            L.append(matmul(f"{t}.mlp2", n, d, 4 * d))
        if s < 3:
            L.append(matmul(f"merge{s}", n // 4, 2 * d, 4 * d))
            n //= 4
    L.append(fc("head", 768, 1000))
    return DnnModel("swin_tiny", L, redundancy=0.85, baseline_accuracy=0.955)


# ---------------------------------------------------------------- FBNet-C ----


def fbnet_c(input_hw: int = 224) -> DnnModel:
    """FBNet-C (Wu et al. 2019) — searched MBConv stack, shape-level approx."""
    L: List[LayerSpec] = []
    h = input_hw
    L.append(conv("stem", 16, 3, 3, 3, h, h, stride=2))
    h = -(-h // 2)
    c_in = 16
    # (expand, c_out, n, stride, kernel)
    cfg = [(1, 16, 1, 1, 3), (6, 24, 1, 2, 3), (1, 24, 3, 1, 3),
           (6, 32, 1, 2, 5), (3, 32, 3, 1, 3), (6, 64, 1, 2, 5),
           (6, 64, 3, 1, 5), (6, 112, 1, 1, 5), (6, 112, 3, 1, 5),
           (6, 184, 1, 2, 5), (6, 184, 3, 1, 5), (6, 352, 1, 1, 3)]
    blk = 0
    for t, c, n, s, k in cfg:
        for i in range(n):
            st = s if i == 0 else 1
            c_mid = c_in * t
            tag = f"b{blk}"
            if t != 1:
                L.append(conv(f"{tag}.pw", c_mid, c_in, 1, 1, h, h))
            L.append(dwconv(f"{tag}.dw", c_mid, k, k, h, h, stride=st))
            h = -(-h // st)
            L.append(conv(f"{tag}.pwl", c, c_mid, 1, 1, h, h))
            c_in = c
            blk += 1
    L.append(conv("head", 1984, 352, 1, 1, h, h))
    L.append(pool("gap", 1984, h, h, R=h, S=h, stride=h))
    L.append(fc("fc", 1984, 1000))
    return DnnModel("fbnet_c", L, redundancy=0.45, baseline_accuracy=0.749)


# ---------------------------------------------------- Hand Shape/Pose ----


def hand_sp(input_hw: int = 256) -> DnnModel:
    """Ge et al. CVPR'19 3D hand shape & pose — hourglass encoder + graph
    CNN decoder, shape-level approximation."""
    L: List[LayerSpec] = []
    h = input_hw
    L.append(conv("stem", 64, 3, 7, 7, h, h, stride=2)); h //= 2
    L.append(conv("stem2", 128, 64, 3, 3, h, h))
    L.append(pool("pool1", 128, h, h)); h //= 2
    # 2-stack hourglass at 64x64, channels 160 (compact per Ge et al.)
    for s in range(2):
        ch = 160
        hh = h
        c_in = 128 if s == 0 else 160
        for d in range(3):  # down path
            L.append(conv(f"hg{s}.d{d}a", ch, c_in if d == 0 else ch, 3, 3, hh, hh))
            L.append(conv(f"hg{s}.d{d}b", ch, ch, 3, 3, hh, hh, stride=2))
            hh //= 2
        L.append(conv(f"hg{s}.mid", ch, ch, 3, 3, hh, hh))
        for d in range(3):  # up path
            hh *= 2
            L.append(conv(f"hg{s}.u{d}", ch, ch, 3, 3, hh, hh))
        L.append(conv(f"hg{s}.out", 160, ch, 1, 1, h, h))
    # latent feature + graph-CNN mesh decoder (matmuls over 1280-vertex mesh)
    L.append(conv("latent", 512, 160, 3, 3, h, h, stride=2))
    L.append(pool("gap", 512, h // 2, h // 2, R=h // 2, S=h // 2, stride=h // 2))
    L.append(fc("fc_latent", 512, 1024))
    for g in range(4):
        L.append(matmul(f"graph{g}", 1280, 96 if g < 3 else 3, 96))
    L.append(fc("pose_head", 1024, 63))  # 21 joints x 3
    return DnnModel("hand_sp", L, redundancy=0.5, task="pose",
                    baseline_accuracy=0.85)


# -------------------------------------------------------------- Sp2Dense ----


def sp2dense(input_hw: int = 224) -> DnnModel:
    """Ma & Karaman ICRA'18 sparse-to-dense depth — ResNet18-ish encoder +
    upconv decoder (shape-level approximation; RGBd input = 4 channels)."""
    L: List[LayerSpec] = []
    h = input_hw
    L.append(conv("stem", 64, 4, 7, 7, h, h, stride=2)); h //= 2
    L.append(pool("pool1", 64, h, h)); h //= 2
    c_in = 64
    for s, (c, stride) in enumerate([(64, 1), (128, 2), (256, 2), (512, 2)]):
        for b in range(2):  # basic blocks
            st = stride if b == 0 else 1
            L.append(conv(f"s{s}b{b}.c1", c, c_in, 3, 3, h, h, stride=st))
            h = -(-h // st)
            L.append(conv(f"s{s}b{b}.c2", c, c, 3, 3, h, h))
            if st != 1 or c_in != c:
                L.append(conv(f"s{s}b{b}.down", c, c_in, 1, 1, h * st, h * st, stride=st))
            L.append(eltwise(f"s{s}b{b}.add", c, h, h))
            c_in = c
    L.append(conv("bottleneck", 512, 512, 1, 1, h, h))
    # decoder: 4 upproj stages
    c_dec = 512
    for d in range(4):
        h *= 2
        L.append(conv(f"up{d}", c_dec // 2, c_dec, 5, 5, h, h))
        c_dec //= 2
    L.append(conv("pred", 1, c_dec, 3, 3, h, h))
    return DnnModel("sp2dense", L, redundancy=0.8, task="depth",
                    baseline_accuracy=0.81)  # delta1 accuracy


# -------------------------------------------------------------- PlaneRCNN ----


def planercnn(input_hw: int = 480) -> DnnModel:
    """Liu et al. CVPR'19 — Mask-RCNN-style plane detection on a ResNet50-FPN
    backbone (shape-level approximation incl. RPN + heads + mask deconv)."""
    base = resnet50(input_hw)
    L = [l for l in base.layers if not l.name.startswith(("gap", "fc"))]
    hs = [input_hw // 4, input_hw // 8, input_hw // 16, input_hw // 32]
    # FPN lateral + output convs
    for i, (c_in, h) in enumerate(zip([256, 512, 1024, 2048], hs)):
        L.append(conv(f"fpn.lat{i}", 256, c_in, 1, 1, h, h))
        L.append(conv(f"fpn.out{i}", 256, 256, 3, 3, h, h))
    # RPN on each level
    for i, h in enumerate(hs):
        L.append(conv(f"rpn{i}.conv", 256, 256, 3, 3, h, h))
        L.append(conv(f"rpn{i}.cls", 3, 256, 1, 1, h, h))
        L.append(conv(f"rpn{i}.box", 12, 256, 1, 1, h, h))
    # box head (RoIAlign 7x7, 256 rois -> batch as pixels) + mask head
    L.append(matmul("box.fc1", 256, 1024, 256 * 49))
    L.append(matmul("box.fc2", 256, 1024, 1024))
    for m in range(4):
        L.append(conv(f"mask.c{m}", 256, 256, 3, 3, 14, 14))
    L.append(conv("mask.deconv", 256, 256, 2, 2, 28, 28))
    L.append(conv("mask.pred", 2, 256, 1, 1, 28, 28))
    # plane params head
    L.append(matmul("plane.fc", 256, 3, 1024))
    return DnnModel("planercnn", L, redundancy=0.75, task="detection",
                    baseline_accuracy=0.60)


# --------------------------------------------------- DAG-structured models -
#
# Three multi-branch workloads exercising the layer-DAG axis (paper
# Sec. III generalized: "Each layer takes its previous layer's output as
# input" becomes per-edge precedence).  Node i of the DAG is layers[i];
# parallel branches let one request occupy several accelerators at once.


def asr_encdec(input_hw: int = 80) -> DnnModel:
    """Speech encoder/decoder split: the audio conv encoder and the text
    prompt embedding are independent sources that join at the cross-
    attention fusion, then a decoder chain produces tokens.

    ``0:aud_stem -> 1:aud_enc1 -> 2:aud_enc2 -\\
                                               > 5:fusion -> 6:dec1 -> 7:dec2 -> 8:lm_head
       3:txt_embed -> 4:txt_proj -------------/``
    """
    from repro_torch.core.dag import LayerDag

    h = input_hw
    L: List[LayerSpec] = [
        conv("aud_stem", 256, 1, 3, 3, h, 3000 // 8),
        conv("aud_enc1", 384, 256, 3, 3, h // 2, 3000 // 16, stride=2),
        conv("aud_enc2", 512, 384, 3, 3, h // 4, 3000 // 32, stride=2),
        fc("txt_embed", 512, 1024),
        matmul("txt_proj", 448, 512, 1024),
        matmul("fusion", 448, 512, 512),
        matmul("dec1", 448, 2048, 512),
        matmul("dec2", 448, 512, 2048),
        fc("lm_head", 512, 8192),
    ]
    dag = LayerDag(preds=((), (0,), (1,), (), (3,), (2, 4), (5,), (6,), (7,)))
    return DnnModel("asr_encdec", L, redundancy=0.65, task="asr",
                    baseline_accuracy=0.88, dag=dag)


def vlm_2branch(input_hw: int = 224) -> DnnModel:
    """Two-branch vision-language model: a shared stem fans out into a
    conv vision encoder and a matmul text encoder that rejoin at a
    fusion layer feeding the answer head.

    ``0:stem -> 1:vis1 -> 2:vis2 -> 3:vis_proj -\\
                                                 > 7:fusion -> 8:head
       0:stem -> 4:txt1 -> 5:txt2 -> 6:txt_proj -/``
    """
    from repro_torch.core.dag import LayerDag

    h = input_hw
    L: List[LayerSpec] = [
        conv("stem", 96, 3, 4, 4, h, h, stride=4),
        conv("vis1", 192, 96, 3, 3, h // 8, h // 8),
        conv("vis2", 384, 192, 3, 3, h // 16, h // 16),
        matmul("vis_proj", (h // 16) ** 2, 512, 384),
        matmul("txt1", 256, 1024, 512),
        matmul("txt2", 256, 1024, 1024),
        matmul("txt_proj", 256, 512, 1024),
        matmul("fusion", 256, 512, 512),
        fc("head", 512, 3129),
    ]
    dag = LayerDag(
        preds=((), (0,), (1,), (2,), (0,), (4,), (5,), (3, 6), (7,))
    )
    return DnnModel("vlm_2branch", L, redundancy=0.7, task="vqa",
                    baseline_accuracy=0.72, dag=dag)


def moe_4expert(input_hw: int = 224) -> DnnModel:
    """Mixture-of-experts block: a router fans out to four parallel
    expert FFNs whose outputs a combine node reduces before the head.

    ``0:router -> {1,2,3,4}:expert -> 5:combine -> 6:head``
    """
    from repro_torch.core.dag import LayerDag

    L: List[LayerSpec] = [
        matmul("router", 196, 768, 768),
        matmul("expert0", 196, 3072, 768),
        matmul("expert1", 196, 3072, 768),
        matmul("expert2", 196, 3072, 768),
        matmul("expert3", 196, 3072, 768),
        matmul("combine", 196, 768, 3072),
        fc("head", 768, 1000),
    ]
    dag = LayerDag(
        preds=((), (0,), (0,), (0,), (0,), (1, 2, 3, 4), (5,))
    )
    return DnnModel("moe_4expert", L, redundancy=0.75,
                    baseline_accuracy=0.78, dag=dag)


# ------------------------------------------------------------------ registry -

ZOO: Dict[str, Callable[[], DnnModel]] = {
    "vgg11": vgg11,
    "resnet50": resnet50,
    "mobilenetv2_ssd": mobilenetv2_ssd,
    "inceptionv3": inceptionv3,
    "swin_tiny": swin_tiny,
    "fbnet_c": fbnet_c,
    "hand_sp": hand_sp,
    "sp2dense": sp2dense,
    "planercnn": planercnn,
    "asr_encdec": asr_encdec,
    "vlm_2branch": vlm_2branch,
    "moe_4expert": moe_4expert,
}


def get_model(name: str) -> DnnModel:
    try:
        return ZOO[name]()
    except KeyError:
        raise KeyError(f"unknown DNN '{name}'; available: {sorted(ZOO)}") from None
