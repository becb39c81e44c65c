"""RTNSTV's work (the ``rtnstv`` configuration): the forward's conv FLOPs
per frame (about 8.2 GFLOP at 640×360) and K1's calls.  There is no K2
call: every conv but the residual ones is the library's."""

from portbench.counts.common import conv_flops
from portbench.core.peaks import ELEMENT_BYTES


def layers(cfg, h, w):
    """(name, Ho, Wo, Cin, Cout, k) of each conv of one frame: the three
    encoder convs (stride 1, 2, 2), the residual convs, the two stride-2
    transposed convs (at their input's size: each input pixel meets every
    tap once, the count of ``torch.utils.flop_counter``) and the head."""
    e, d = cfg["encoder"], cfg["decoder"]["widths"]
    out, cin = [], 3
    for i, (cout, s) in enumerate(zip(e["widths"], e["strides"])):
        h, w = h // s, w // s
        out.append((f"conv{i + 1}", h, w, cin, cout, 3))
        cin = cout
    wd = cfg["residual_width"]
    out += [(f"res{i}", h, w, wd, wd, 3)
            for i in range(2 * cfg["residual_blocks"])]
    for i, (ci, co) in enumerate(zip(d[:-1], d[1:])):
        out.append((f"deconv{i + 1}", h, w, ci, co, 3))
        h, w = 2 * h, 2 * w
    hd = cfg["head"]
    out.append(("conv4", h, w, hd["in"], hd["out"], 3))
    return out


def forward_flops(cfg, h, w):
    return sum(conv_flops(*l[1:]) for l in layers(cfg, h, w))


def kernel_calls(cfg, n, h, w, dtype):
    """(FLOPs, bytes) of each K1 call (the residual convs) of one forward
    over ``n`` frames of H × W, by ``counts/reconet.py``'s formula: input,
    output and weights in ``dtype``, K1's statistics in float32."""
    e = ELEMENT_BYTES[dtype]
    return [(n * conv_flops(ho, wo, cin, cout, k),
             e * (n * ho * wo * (cin + cout) + 9 * cin * cout)
             + 4 * 2 * n * cout)
            for name, ho, wo, cin, cout, k in layers(cfg, h, w)
            if name.startswith("res")]
