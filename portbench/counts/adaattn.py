"""AdaAttN's work (the ``adaattn`` configuration): the serving forward per
image, the image trainer's step, and K3's, K4's and K5's calls."""

from portbench.counts.common import conv_flops, flops, vgg_convs
from portbench.core.peaks import ELEMENT_BYTES

VGG19_CFG = [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
             512, 512, 512, 512, "M", 512, 512, 512, 512, "M"]
VGG19_LAST = 29   # relu5_1
DECODER = [(8, 512, 512), (8, 512, 256), (4, 512, 256), (4, 256, 256),
           (4, 256, 256), (4, 256, 128), (2, 128, 128), (2, 128, 64),
           (1, 64, 64), (1, 64, 3)]   # (stride of the input size, cin, cout)
LEVELS = (4, 8, 16)   # relu3_1, relu4_1, relu5_1: H / LEVEL rows


def levels(cfg, h, w):
    """(tokens, qk width, v width) of the three attention levels."""
    return [((h // s) * (w // s), d, c)
            for s, d, c in zip(LEVELS, cfg["qk_dims"], cfg["v_dims"])]


def attention_flops(n, m, d, c):
    """S = QKᵀ, M1 = A·V, M2 = A·V²: 2·n·m·(d + 2c)."""
    return 2 * n * m * (d + 2 * c)


def encode_flops(h, w):
    return flops(vgg_convs(VGG19_CFG, VGG19_LAST, h, w))


def qkv_flops(cfg, h, w):
    return sum(2 * n * (2 * d * d + c * c) for n, d, c in levels(cfg, h, w))


def decoder_flops(h, w):
    return sum(conv_flops(h // s, w // s, ci, co, 3) for s, ci, co in DECODER)


def stylizer_flops(cfg, h, w):
    """The attention modules (convs and attention) and the decoder."""
    return (qkv_flops(cfg, h, w) + decoder_flops(h, w)
            + sum(attention_flops(n, n, d, c)
                  for n, d, c in levels(cfg, h, w)))


def forward_flops(cfg, h, w):
    """One served image: its content and style encoded, then stylized."""
    return 2 * encode_flops(h, w) + stylizer_flops(cfg, h, w)


def k3_calls(cfg, n, h, w, dtype):
    """(FLOPs, bytes) of the three K3 calls of a forward over ``n`` images:
    q, k, v read in ``dtype``, M1, M2 and the row logsumexp written in
    float32."""
    e = ELEMENT_BYTES[dtype]
    return [(n * attention_flops(t, t, d, c),
             n * (e * (2 * t * d + t * c) + 4 * (2 * t * c + t)))
            for t, d, c in levels(cfg, h, w)]


def k45_calls(cfg, n, h, w, dtype):
    """(FLOPs, bytes) of each K4 (dQ) and K5 (dK, dV) call of one backward:
    the gradient of A (4·n·m·c) and dQ (2·n·m·d) in K4, dK (2·n·m·d) and
    dV (4·n·m·c) in K5, with no recomputation counted; q, k, v in
    ``dtype`` and dM1, dM2 and the logsumexp in float32 read, the
    gradients written in ``dtype``."""
    e = ELEMENT_BYTES[dtype]
    out = []
    for t, d, c in levels(cfg, h, w):
        read = e * (2 * t * d + t * c) + 4 * (2 * t * c + t)
        work = n * attention_flops(t, t, d, c)   # 4·n·m·c + 2·n·m·d each
        out.append((work, n * (read + e * t * d)))
        out.append((work, n * (read + e * (t * d + t * c))))
    return out


def step_kernel_calls(cfg):
    """K3 twice a level (the stylizer's attention and the conv-free
    target), K4 and K5 once a level (the stylizer's backward)."""
    t = cfg["train"]
    h, w = t["crop_size"]
    b = t["batch_size"]
    fwd = k3_calls(cfg, b, h, w, t["dtype"])
    return fwd + fwd + k45_calls(cfg, b, h, w, t["dtype"])


def step_flops(cfg):
    """One image step: content and style encoded (forward), the stylizer
    forward and backward (weight gradients of every conv, input gradients
    of the decoder and the attention, none into the VGG features), the
    conv-free target's attention, the stylized images encoded forward and
    backward (input gradient only)."""
    t = cfg["train"]
    h, w = t["crop_size"]
    b = t["batch_size"]
    att = sum(attention_flops(n, n, d, c) for n, d, c in levels(cfg, h, w))
    enc = encode_flops(h, w)
    fwd = stylizer_flops(cfg, h, w)
    bwd = qkv_flops(cfg, h, w) + 2 * decoder_flops(h, w) + 2 * att
    return b * (2 * enc + fwd + bwd + att + 2 * enc)
