"""Mamba2 weights under which the SSD scan shows in what the model emits.

With the model's own init (in_proj and conv_w of std 0.02) x, B and C
come out of the conv at about 3e-3, the SSM state at about 1e-6, and the
scan's share of y at about 1e-8 beside ``D * x`` at 3e-3: logits and
tokens then do not depend on the state at all.  ``live_state`` rescales
the x, B and C columns of ``in_proj`` and ``conv_w`` to order-one
activations, so the scan's term outweighs ``D * x`` (about 3x on the
reduced config) and zeroing the state moves the next logits by about
0.5.  It takes numpy or torch leaves and imports neither JAX nor the
port, so the JAX tests, the card tests and ``chip_smoke.py`` share it.
"""

# spreads of the pre-conv projections for a unit-RMS input, whatever
# d_model: the weights' std is this over sqrt(d_model)
X_SPREAD = 2.0  # the in_proj columns feeding x
BC_SPREAD = 4.0  # those feeding B and C
CONV_STD = 0.5


def live_state(params, cfg):
    """A copy of ``params`` (the model's tree, numpy or torch leaves) with
    every Mamba2 layer's x/B/C projection and conv rescaled to the
    stated spreads; other leaves are shared, not copied."""
    m = cfg.mamba
    di = m.d_inner(cfg.d_model)
    N = m.d_state
    blocks = {}
    for name, lp in params["blocks"].items():
        lp = dict(lp)
        if "mamba" in lp:
            p = dict(lp["mamba"])
            w = p["in_proj"] * 1  # a copy in either library
            for lo, hi, spread in ((di, 2 * di, X_SPREAD),
                                   (2 * di, 2 * di + 2 * N, BC_SPREAD)):
                cols = w[..., lo:hi]
                std = spread / cfg.d_model ** 0.5
                w[..., lo:hi] = cols * (std / float(cols.std()))
            p["in_proj"] = w
            p["conv_w"] = p["conv_w"] * (CONV_STD / float(p["conv_w"].std()))
            lp["mamba"] = p
        blocks[name] = lp
    return {**params, "blocks": blocks}
