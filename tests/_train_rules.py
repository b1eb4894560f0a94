"""The train step's tolerances and checks (JAX-free, so the CUDA tests
use them too): gradients against gradients, and params after one AdamW
step from zero moments, whose move amplifies the sign of every gradient
entry."""
import numpy as np
import torch

EPS32 = float(np.finfo(np.float32).eps)
# f32 loss: the same math in other summation orders (observed <= 7.7e-8)
LOSS_RTOL = 1e-6
# each gradient leaf within GRAD_RTOL of its largest magnitude (observed
# <= 5e-6 over the ten configs, both remat modes, with and without the
# chunked loss)
GRAD_RTOL = 2e-5
# the card against the CPU (tests/test_torch_cuda.py, chip_smoke.py phase
# 15): recurrentgemma's RG-LRU gradients, run back through products of its
# gates over 32 positions, round apart by up to 3.1e-5 between the two
# devices; every other config <= 1e-5
CARD_GRAD_RTOL = 1e-4
# AdamW's step from one state; a param moves by lr * x / (|x| + eps), x
# its clipped gradient. Where the reference run's |g| exceeds 2 GRAD_RTOL
# of its leaf's largest, the two runs' x share a sign and the move
# differs by at most lr * 2 eps dx / x^2 (dx: the gradient's tolerance
# plus the clip scale's rounding), plus PARAM_ULPS ulps of |p| + lr.
# Within the gradients' noise the sign may differ and the move by up to
# 2 lr; at most NOISE_SHARE of a config's entries may use that
# (observed <= 0.18%)
PARAM_ULPS = 4.0
NOISE_SHARE = 5e-3
ADAM_EPS = 1e-8


def assert_grads(got, want, label, rtol=GRAD_RTOL):
    assert len(got) == len(want), label
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape and g.dtype == w.dtype, (label, i)
        scale = max(float(w.abs().max()), 1e-30)
        err = float((g - w).abs().max())
        assert err <= rtol * scale, (label, i, err / scale)


def assert_first_step(p0, got, want, ref_grads, lr, clip, label,
                      grad_rtol=GRAD_RTOL):
    """Params after one AdamW step from zero moments under the rule above
    (``grad_rtol`` the gradients' tolerance); returns the count of entries
    held only to 2 lr."""
    n_noise = n_all = 0
    for i, (p, a, b, g) in enumerate(zip(p0, got, want, ref_grads)):
        gmax = float(g.abs().max())
        x = g.abs() * clip
        dx = grad_rtol * gmax * clip + 4 * EPS32 * x
        base = PARAM_ULPS * EPS32 * (p.abs() + lr)
        held = g.abs() > 2 * grad_rtol * gmax
        tol = torch.where(held, base + lr * 2 * ADAM_EPS * dx
                          / torch.clamp_min(x * x, 1e-30),
                          2 * lr + base)
        err = (a - b).abs()
        assert bool((err <= tol).all()), (label, i, float((err / tol).max()))
        n_noise += int(((err > base) & ~held).sum())
        n_all += err.numel()
    assert n_noise <= NOISE_SHARE * n_all, (label, n_noise, n_all)
    return n_noise
