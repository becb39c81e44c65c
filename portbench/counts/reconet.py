"""ReCoNet's work (the ``reconet`` configuration): the forward's conv FLOPs
per frame (175 GFLOP at 512², BENCH.md's hand count), the flow trainer's
step, and K1's and K2's calls."""

from portbench.counts.common import conv_flops, flops, vgg_convs
from portbench.core.peaks import ELEMENT_BYTES

VGG16_CFG = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
             512, 512, 512, "M", 512, 512, 512, "M"]
VGG16_LAST = 22   # relu4_3


def layers(cfg, h, w):
    """(name, Ho, Wo, Cin, Cout, k) of each conv of one frame: the 9×9 stem,
    two stride-2 convs, the residual convs, two upsample convs (at the
    upsampled size) and the 9×9 head."""
    wd = cfg["widths"]
    c1, c2, c3 = wd["conv1"], wd["conv2"], wd["conv3"]
    out = [("stem", h, w, 3 * cfg["input_frame_num"], c1, 9),
           ("conv2", h // 2, w // 2, c1, c2, 3),
           ("conv3", h // 4, w // 4, c2, c3, 3)]
    out += [(f"res{i}", h // 4, w // 4, c3, c3, 3)
            for i in range(2 * cfg["residual_blocks"])]
    out += [("deconv1", h // 2, w // 2, c3, c2, 3),
            ("deconv2", h, w, c2, c1, 3),
            ("head", h, w, c1, 3, 9)]
    return out


def forward_flops(cfg, h, w):
    return sum(conv_flops(*l[1:]) for l in layers(cfg, h, w))


def kernel_calls(cfg, n, h, w, dtype):
    """(FLOPs, bytes) of each K1 (residual convs) and K2 (stem and head)
    call of one forward over ``n`` frames of H × W: input, output and
    weights in ``dtype``, K1's statistics in float32."""
    e = ELEMENT_BYTES[dtype]
    out = []
    for name, ho, wo, cin, cout, k in layers(cfg, h, w):
        if name.startswith("res"):
            nbytes = (e * (n * ho * wo * (cin + cout) + 9 * cin * cout)
                      + 4 * 2 * n * cout)
        elif name in ("stem", "head"):
            nbytes = e * (n * ho * wo * (cin + cout) + k * k * cin * cout)
        else:
            continue
        out.append((n * conv_flops(ho, wo, cin, cout, k), nbytes))
    return out


def step_flops(cfg):
    """One flow step: the stylizer over both frames of each pair, forward
    and backward (weight and input gradients, but the stem's input
    gradient); the frozen VGG16 to relu4_3 over the styled and the input
    frames forward, and over the styled frames backward (input gradient
    only); the style loss's Grams of the styled frames, forward and
    backward."""
    t = cfg["train"]
    h, w = t["img_size"]
    b = t["batch_size"]
    stylizer = forward_flops(cfg, h, w)
    stem = conv_flops(*layers(cfg, h, w)[0][1:])
    vgg = vgg_convs(VGG16_CFG, VGG16_LAST, h, w)
    taps = [c for i, c in enumerate(vgg) if i in (1, 3, 6, 9)]
    grams = sum(2 * c[3] * c[3] * c[0] * c[1] for c in taps)
    images = 2 * b
    return (images * (3 * stylizer - stem)
            + images * 2 * flops(vgg) + images * flops(vgg)
            + images * 3 * grams)
