"""Mathematical work from shapes: 2 FLOPs a multiply-add, each input byte
read once and each output byte written once."""


def conv_flops(ho, wo, cin, cout, k):
    """2·Ho·Wo·Cin·Cout·k² for one image."""
    return 2 * ho * wo * cin * cout * k * k


def vgg_convs(cfg, last_index, h, w):
    """(Ho, Wo, Cin, Cout, k) of each VGG conv up to ``last_index``."""
    out, idx, cin = [], 0, 3
    for v in cfg:
        if idx > last_index:
            break
        if v == "M":
            h, w, idx = h // 2, w // 2, idx + 1
        else:
            out.append((h, w, cin, v, 3))
            cin, idx = v, idx + 2
    return out


def flops(convs):
    return sum(conv_flops(*c) for c in convs)
