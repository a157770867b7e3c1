"""The port's CUDA kernels vs their plain versions, on the card.

Marked `cuda`; every test skips where torch sees no GPU (decided inside the
fixture, never at import). The shapes here are the awkward ones the main path
does not reach: ragged tiles, channel counts off the kernel's tile sizes,
signed pads and 12-tap filters, every up/down pair, rows on and off the
16-byte vector, more than 65535 planes, both depth-to-space orders, 1-byte
elements, warps of non-square images onto ragged outputs partly outside the
image; and
each autograd Function's backward on the card. The main-path shapes are
checked by chip_smoke.py. Run on a machine with an H100 (it has no
JAX, so skip the suite's conftest):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Tolerances: float32 runs with TF32 off and differs from cuDNN only in the
order of float32 sums; bfloat16 outputs round once in the kernel and after
each op in the plain version, a few bf16 steps (2^-8 relative) at most.
"""

import numpy as np
import pytest
import torch

from vtoonify_tpu_torch.ops import kernels

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rand(rng, *shape, scale=1.0, shift=0.0):
    return torch.from_numpy((rng.randn(*shape) * scale + shift).astype(np.float32))


def _close(got, want, dtype):
    err = (got.float() - want.float()).abs().max().item()
    ref = max(1.0, want.float().abs().max().item())
    assert err <= TOL[dtype] * ref, (err, ref)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,cin,cout,h,w,modulated,act", [
    (2, 5, 7, 9, 13, True, True),       # everything ragged
    (1, 16, 64, 8, 16, True, False),    # exact tiles, raw conv
    (3, 24, 96, 17, 33, False, True),   # folded form, partial Cout tile
    (1, 8, 3, 1, 1, True, True),        # single pixel
    # bf16 runs the tensor-core kernel: 8x16 px tiles, 32-channel K chunks,
    # BN of 32/64/128 output channels from Cout
    (1, 40, 64, 16, 16, True, True),    # Cin not a multiple of 16 or 32
    (2, 64, 72, 12, 20, False, True),   # Cout not a multiple of BN
    (1, 512, 2048, 6, 10, True, True),  # the up conv's Cout = 4 * 512
    (2, 96, 128, 28, 28, True, True),   # 28 x 28: ragged against the tile
    (1, 48, 40, 17, 33, True, False),   # 17 x 33, raw conv with s and d
    (3, 64, 96, 20, 24, True, True),    # batch 3 with s, d and bias
])
def test_modconv3x3(dev, dtype, b, cin, cout, h, w, modulated, act):
    rng = np.random.RandomState(0)
    x = _rand(rng, b, cin, h, w)
    wt = _rand(rng, 3, 3, cin, cout, scale=1.0 / np.sqrt(9 * cin))
    s = _rand(rng, b, cin, scale=0.5, shift=1.0) if modulated else None
    d = _rand(rng, b, cout, scale=0.1, shift=1.0) if modulated else None
    bias = _rand(rng, cout, scale=0.1) if act else None
    args = [None if t is None else t.to(dev, dtype) for t in (x, wt, s, d, bias)]
    _close(kernels.modconv3x3(*args), kernels.modconv3x3_plain(*args), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,with_bias,misalign", [
    ((2, 7, 5, 3), True, False),      # planes off the 16-byte vector: scalars
    ((18, 512), True, False),         # (N, C) form, C on the vector
    ((3, 4, 2, 2), False, False),     # 4-element planes: f32 vector, bf16 scalar
    ((2, 32, 16, 16), True, False),   # planes on the vector, several chunks
    ((2, 3, 40, 40), True, False),    # 1600-element planes, ragged last chunk
    ((1, 65540, 2, 4), True, False),  # more than 65535 planes, vectors
    ((1, 65537, 3), True, False),     # more than 65535 planes, scalars
    ((5, 24), True, False),           # (N, C) form, C a multiple of 8
    ((5, 13), True, False),           # (N, C) form, C off the vector
    ((5, 13), False, False),
    ((2, 8, 4, 4), True, True),       # a contiguous view off 16-byte alignment
    ((6, 16), True, True),
])
def test_fused_leaky_relu(dev, dtype, shape, with_bias, misalign):
    rng = np.random.RandomState(1)
    x = _rand(rng, *shape).to(dev, dtype)
    if misalign:  # same values, one element into a fresh allocation
        x = torch.cat([x.new_zeros(1), x.reshape(-1)])[1:].view(shape)
        assert x.data_ptr() % 16 and x.is_contiguous()
    bias = _rand(rng, shape[1]).to(dev, dtype) if with_bias else None
    _close(kernels.fused_leaky_relu(x, bias),
           kernels.fused_leaky_relu_plain(x, bias), dtype)


_UP_DOWN = [(u, d) for u in ((1, 1), (2, 1), (1, 2), (2, 2))
            for d in ((1, 1), (2, 1), (1, 2), (2, 2))]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,kt,up,down,pad", [
    ((2, 3, 19, 22), 4, (2, 2), (1, 1), (2, 1, 2, 1)),    # ToRGB's upsample_2x
    ((2, 3, 19, 22), 4, (1, 1), (1, 1), (2, 1, 2, 1)),    # blur
    ((2, 3, 19, 22), 4, (1, 1), (2, 2), (1, 1, 1, 1)),    # downsample_2x
    ((2, 3, 19, 22), 3, (2, 1), (1, 2), (-1, 2, 0, -1)),  # per-axis, negative pads
    ((2, 3, 19, 22), 8, (2, 2), (2, 2), (3, 4, 4, 3)),    # 8 taps
    ((2, 3, 19, 22), 12, (2, 2), (1, 1), (6, 5, -2, 7)),  # widest taps, signed pads
    ((2, 3, 19, 22), (1, 12), (2, 1), (1, 1), (6, 5, 0, 0)),     # augment SYM6 x-up
    ((2, 3, 19, 22), (12, 1), (1, 1), (1, 2), (0, 0, -1, -1)),   # augment SYM6 y-down
    ((2, 3, 19, 22), (12, 5), (1, 2), (2, 1), (-3, -1, 4, -2)),  # mixed, negative pads
    # every (up, down) pair the wrapper admits, on a 17 x 33 plane (ragged
    # against the tiles' 8-row and 32-column steps), signed pads
    *[((1, 2, 17, 33), 4, u, d, (2, -1, -1, 2)) for u, d in _UP_DOWN],
    # 2060 x 28 planes (the augment's height, a width off the 16-byte vector)
    ((1, 2, 2060, 28), (1, 12), (2, 1), (1, 1), (6, 5, 0, 0)),
    ((1, 2, 2060, 28), (12, 1), (1, 2), (1, 1), (0, 0, 6, 5)),
    ((1, 2, 2060, 28), (12, 5), (1, 1), (1, 2), (-1, 3, -1, -1)),
    ((1, 2, 2060, 28), 4, (2, 2), (1, 1), (2, 1, 2, 1)),
    # rows on the 16-byte vector in and out (16-byte loads and stores)
    ((2, 2, 24, 64), (12, 1), (1, 2), (1, 1), (0, 0, 6, 5)),
    ((2, 2, 40, 128), (1, 12), (1, 1), (2, 1), (-1, -1, 0, 0)),
    ((1, 3, 33, 256), 4, (1, 1), (1, 1), (2, 2, 2, 2)),
    # more than 65535 planes (the grid's z dimension folds into a loop)
    ((1, 65540, 2, 3), 4, (2, 2), (1, 1), (2, 1, 2, 1)),
])
def test_upfirdn2d(dev, dtype, shape, kt, up, down, pad):
    rng = np.random.RandomState(2)
    x = _rand(rng, *shape).to(dev, dtype)
    kt = (kt, kt) if isinstance(kt, int) else kt
    k = torch.from_numpy(rng.rand(*kt).astype(np.float32))
    _close(kernels.upfirdn2d(x, k, up, down, pad),
           kernels.upfirdn2d_plain(x, k, up, down, pad), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.uint8])
@pytest.mark.parametrize("phase_minor", [False, True])
@pytest.mark.parametrize("shape", [
    (2, 12, 5, 7),         # odd width: single-element words
    (2, 8, 3, 28),         # the temporal crop's 28 px rows: 8-byte bf16 words
    (1, 16, 4, 32),        # rows on the 16-byte vector for every dtype
    (2, 4 * 32770, 1, 1),  # more than 65535 planes of 1 x 1 input pixels
])
def test_depth_to_space2(dev, dtype, phase_minor, shape):
    x = torch.arange(int(np.prod(shape)), device=dev).reshape(shape)
    x = (x % 251).to(dtype)
    got = kernels.depth_to_space2(x, phase_minor)
    assert torch.equal(got, kernels.depth_to_space2_plain(x, phase_minor))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,c,h,w,ho,wo,scale,shift", [
    (2, 6, 37, 53, 23, 29, 1.3, 0.0),     # ragged output, non-square input
    (1, 3, 64, 40, 70, 90, 0.6, 0.4),     # affine partly outside the image
    (3, 1, 17, 17, 5, 300, 4.0, -0.2),    # strong minification, long rows
    # the kernel's paths: rows of a multiple of 4 outputs (packed stores) and
    # ragged ones (scalar tail); the 6-channel instance and the runtime
    # channel count (1, 3, 7)
    (2, 6, 40, 52, 24, 32, 1.1, 0.1),     # C = 6, packed stores
    (2, 6, 40, 52, 24, 30, 0.9, -0.1),    # C = 6, ragged rows
    (1, 1, 33, 35, 16, 36, 1.2, 0.3),     # C = 1, packed stores
    (2, 3, 33, 35, 17, 21, 0.7, 0.0),     # C = 3, ragged rows
    (1, 7, 29, 31, 19, 28, 1.0, 0.2),     # C = 7, packed stores
    (65537, 1, 3, 3, 2, 4, 1.0, 0.1),     # more than 65535 samples
])
def test_affine_warp(dev, dtype, n, c, h, w, ho, wo, scale, shift):
    """Against the plain version (F.grid_sample on the same affine's grid):
    [-1, 1] images, so float32 differs by coordinate rounding only (values
    within 1e-4) and bf16 by one output rounding."""
    rng = np.random.RandomState(3)
    img = torch.tanh(_rand(rng, n, c, h, w)).to(dev, dtype)
    theta = torch.from_numpy(rng.randn(n, 2, 3).astype(np.float32) * 0.2)
    theta[:, 0, 0] += scale
    theta[:, 1, 1] += scale
    theta[:, :, 2] += shift
    from vtoonify_tpu_torch.train.augment import _pixel_affine_coefs

    coef = _pixel_affine_coefs(theta, (ho, wo), (h, w)).to(dev).contiguous()
    got = kernels.affine_warp(img, coef, (ho, wo))
    assert got.shape == (n, c, ho, wo) and got.dtype == dtype
    _close(got, kernels.affine_warp_plain(img, coef, (ho, wo)), dtype)
    if shift:
        assert (got == 0).any() and (got != 0).any()  # some samples outside


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [6, 3])
def test_affine_warp_non_finite_coefs_give_zeros(dev, dtype, c):
    """NaN, infinite and huge coefficients map every output outside the
    image: zeros, and no read out of bounds (it would fault at the
    synchronize). The image is small, so that a wild gather lands outside
    its allocation."""
    img = torch.ones(4, c, 5, 7, device=dev, dtype=dtype)
    nan, inf = float("nan"), float("inf")
    coef = torch.tensor([[nan] * 6,
                         [1.0, 0.0, nan, 0.0, 1.0, 0.0],
                         [inf, 0.0, 1.0, -inf, 0.0, 1.0],
                         [1.0, 0.0, 1e30, 0.0, 1.0, -1e30]], device=dev)
    got = kernels.affine_warp(img, coef, (6, 8))
    torch.cuda.synchronize()
    assert torch.equal(got, torch.zeros_like(got))


def test_inference_mode_launches_without_a_graph_node(dev, monkeypatch):
    """B2 and B5 launch their kernels without their autograd Functions where
    autograd does not record (inference_mode, no_grad), and take them
    where it does."""
    x = torch.randn(2, 8, 4, 4, device=dev, requires_grad=True)
    bias = torch.zeros(8, device=dev, requires_grad=True)
    img = torch.randn(2, 6, 9, 9, device=dev, requires_grad=True)
    coef = torch.tensor([[1.0, 0.0, 0.5, 0.0, 1.0, 0.5]] * 2, device=dev)

    def refuse(*args):
        raise AssertionError("autograd Function taken")

    kernels.reset_launch_counts()
    with monkeypatch.context() as m:
        m.setattr(kernels._FusedLeakyReLU, "apply", refuse)
        m.setattr(kernels._AffineWarp, "apply", refuse)
        for mode in (torch.inference_mode, torch.no_grad):
            with mode():
                y = kernels.fused_leaky_relu(x, bias)
                z = kernels.affine_warp(img, coef, (5, 5))
            assert y.grad_fn is None and z.grad_fn is None
    assert kernels.launch_counts()["fused_leaky_relu"] == 2
    assert kernels.launch_counts()["affine_warp"] == 2
    y = kernels.fused_leaky_relu(x, bias)
    z = kernels.affine_warp(img, coef, (5, 5))
    assert "FusedLeakyReLU" in type(y.grad_fn).__name__
    assert "AffineWarp" in type(z.grad_fn).__name__
    assert kernels.launch_counts()["fused_leaky_relu"] == 3
    assert kernels.launch_counts()["affine_warp"] == 3


def _backward_matches(dev, kern, plain, inputs):
    grads = []
    for fn in (kern, plain):
        leaves = [x.detach().clone().requires_grad_() for x in inputs]
        y = fn(*leaves)
        g = torch.linspace(-1, 1, y.numel(), device=dev).reshape(y.shape)
        grads.append(torch.autograd.grad(y, leaves, g))
    for a, b in zip(*grads):
        _close(a, b, torch.float32)


def test_backward_on_card(dev):
    """Each autograd Function on CUDA tensors (the kernel forward, the plain
    backward) vs torch.autograd through the plain version, float32."""
    rng = np.random.RandomState(4)
    r = lambda *s, **k: _rand(rng, *s, **k).to(dev)  # noqa: E731
    k2 = torch.from_numpy(rng.rand(4, 4).astype(np.float32))
    k12 = torch.from_numpy(rng.rand(1, 12).astype(np.float32))
    coef = torch.tensor([[1.1, 0.1, -0.4, -0.05, 0.95, 0.7]] * 2, device=dev)
    _backward_matches(dev, kernels.modconv3x3, kernels.modconv3x3_plain,
                      (r(2, 5, 9, 13), r(3, 3, 5, 7, scale=0.2), r(2, 5, shift=1.0),
                       r(2, 7, shift=1.0), r(7)))
    _backward_matches(dev, kernels.fused_leaky_relu, kernels.fused_leaky_relu_plain,
                      (r(2, 7, 5, 3), r(7)))
    for k, up, down, pad in ((k2, (2, 2), (1, 1), (2, 1, 2, 1)),
                             (k12, (1, 1), (2, 1), (-1, -1, 0, 0))):
        _backward_matches(
            dev, lambda x, k=k, u=up, d=down, p=pad: kernels.upfirdn2d(x, k, u, d, p),
            lambda x, k=k, u=up, d=down, p=pad: kernels.upfirdn2d_plain(x, k, u, d, p),
            (r(2, 3, 17, 19),))
    for pm in (False, True):
        _backward_matches(dev, lambda x, pm=pm: kernels.depth_to_space2(x, pm),
                          lambda x, pm=pm: kernels.depth_to_space2_plain(x, pm),
                          (r(2, 12, 5, 7),))
    _backward_matches(dev, lambda x: kernels.affine_warp(x, coef, (11, 13)),
                      lambda x: kernels.affine_warp_plain(x, coef, (11, 13)),
                      (r(2, 3, 15, 17),))


def test_launch_counts_and_refusals(dev):
    kernels.reset_launch_counts()
    x = torch.randn(1, 8, 4, 4, device=dev)
    kernels.fused_leaky_relu(x, torch.zeros(8, device=dev))
    kernels.depth_to_space2(x)
    assert kernels.launch_counts()["fused_leaky_relu"] == 1
    assert kernels.launch_counts()["depth_to_space2"] == 1
    with pytest.raises(TypeError):
        kernels.fused_leaky_relu(x.half())
    with pytest.raises(ValueError):
        kernels.modconv3x3(x, torch.zeros(3, 3, 4, 2, device=dev))
    with pytest.raises(ValueError):
        kernels.upfirdn2d(x, torch.ones(4, 4), up=(4, 4))
    with pytest.raises(ValueError):
        kernels.upfirdn2d(x, torch.ones(1, 13))
    with pytest.raises(ValueError, match="on the CPU"):  # taps go by value
        kernels.upfirdn2d(x, torch.ones(4, 4, device=dev), pad=(2, 1, 2, 1))
    with pytest.raises(ValueError):  # float64 coefficients
        kernels.affine_warp(x, torch.zeros(1, 6, dtype=torch.float64, device=dev),
                            (3, 3))
    kernels.affine_warp(x, torch.zeros(1, 6, device=dev), (3, 3))
    assert kernels.launch_counts()["affine_warp"] == 1
