"""PyTorch port, the hand-written CUDA kernels against their plain versions on
the card.

Every test here is marked ``gpu`` and skips without a CUDA card. The file
imports no JAX, so it also runs on a machine that has only PyTorch:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q
"""
import pytest
import torch

from lidar_layout_tpu_torch.nn.blocks import num_groups_for
from lidar_layout_tpu_torch.ops import attention as A
from lidar_layout_tpu_torch.ops import groupnorm as G
from torch_port_helpers import ATTN_EDGE_CASES, attn_inputs


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels run only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gpu_attention_kernel_matches_plain(cuda_device, dtype):
    dt = getattr(torch, dtype)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    for (b, h, s, d) in [(2, 8, 2048, 32), (2, 4, 1000, 64), (1, 2, 77, 16)]:
        q, k, v = (torch.randn((b, h, s, d), generator=gen, device=cuda_device).to(dt)
                   for _ in range(3))
        kb = torch.zeros((b, s), device=cuda_device)
        kb[0, -s // 4:] = -1e9
        launches = A.flash_attention.launches
        got = A.flash_attention(q, k, v, kb)
        want = A._attend_ref(q, k, v, kb)
        torch.cuda.synchronize()
        assert A.flash_attention.launches == launches + 1
        # f32: summation order only; bf16: the kernel rounds the unnormalised
        # probabilities to bf16 before P.V, the plain version the normalised ones
        tol = 1e-4 if dt == torch.float32 else 3e-2
        assert (got.float() - want.float()).abs().max().item() <= tol


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gpu_group_norm_kernel_matches_plain(cuda_device, dtype):
    dt = getattr(torch, dtype)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    for (b, c, h, w) in [(2, 256, 16, 128), (2, 128, 64, 1024), (2, 40, 5, 7)]:
        x = (torch.randn((b, c, h, w), generator=gen, device=cuda_device) * 2 + 0.3).to(dt)
        gamma = 1 + 0.1 * torch.randn(c, generator=gen, device=cuda_device)
        beta = 0.1 * torch.randn(c, generator=gen, device=cuda_device)
        g = num_groups_for(c)
        for act in (False, True):
            launches = G.group_norm.launches
            got = G.group_norm(x, gamma, beta, g, 1e-6, act)
            want = G._ref(x, gamma, beta, g, 1e-6, act)
            torch.cuda.synchronize()
            assert G.group_norm.launches == launches + 1
            # f32: summation order only; bf16: one output rounding (|y| < 8)
            tol = 1e-4 if dt == torch.float32 else 5e-2
            assert (got.float() - want.float()).abs().max().item() <= tol


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gpu_group_norm_bwd_kernel_matches_plain_and_is_deterministic(cuda_device, dtype):
    dt = getattr(torch, dtype)
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    # one block, a cluster of blocks (f32: 192 KB of x a span, 384 KB with
    # dy), the scalar two-sweep path, and a span too large for the chip
    for (b, c, h, w) in [(2, 256, 16, 128), (2, 768, 16, 128), (2, 40, 5, 7),
                         (1, 128, 64, 1024)]:
        x = (torch.randn((b, c, h, w), generator=gen, device=cuda_device) * 2 + 0.3).to(dt)
        gamma = 1 + 0.1 * torch.randn(c, generator=gen, device=cuda_device)
        beta = 0.1 * torch.randn(c, generator=gen, device=cuda_device)
        dy = torch.randn(x.shape, generator=gen, device=cuda_device).to(dt)
        g = num_groups_for(c)
        for act in (False, True):
            launches = G.group_norm_bwd.launches
            got = G.group_norm_bwd(x, gamma, beta, dy, g, 1e-6, act)
            want = G._group_norm_bwd_ref(x, gamma, beta, dy, g, 1e-6, act)
            again = G.group_norm_bwd(x, gamma, beta, dy, g, 1e-6, act)
            torch.cuda.synchronize()
            assert G.group_norm_bwd.launches == launches + 2
            # both in f32 from the same x and dy; dx rounded to x's dtype,
            # dgamma/dbeta sums of B*H*W products in other orders
            tol_dx = (1e-4, 1e-4) if dt == torch.float32 else (2e-2, 1e-2)
            for part, ref, (atol, rtol) in zip(got, want, (tol_dx, (1e-3, 1e-4), (1e-3, 1e-4))):
                assert part.dtype == ref.dtype and part.shape == ref.shape
                scale = ref.float().abs().max().item()
                assert (part.float() - ref.float()).abs().max().item() <= atol + rtol * scale
            # no atomics: a second launch gives the same bits
            assert all(torch.equal(a, b_) for a, b_ in zip(got, again))


@pytest.mark.gpu
def test_gpu_group_norm_paths(cuda_device):
    # the flagship's decoder groups of 128-512 KB go to clusters of 2-8
    # blocks, the U-Net's to one block; a span no 8 blocks hold, or an H*W
    # that is no multiple of the 16-byte pack, takes the two-sweep path
    bf, f32 = torch.bfloat16, torch.float32
    assert G.kernel_path(bf, 768, 16 * 128, 32) == 1
    assert [G.kernel_path(bf, c, hw, 32) for c, hw in
            ((256, 32 * 256), (128, 64 * 512), (128, 64 * 1024))] == [2, 4, 8]
    assert G.kernel_path(f32, 64, 128 * 1024, 4) == 0
    assert G.kernel_path(f32, 40, 35, 20) == 0
    assert G.kernel_path(bf, 768, 16 * 128, 32, backward=True) == 2
    gen = torch.Generator(device=cuda_device).manual_seed(6)
    x = torch.randn((1, 64, 128, 1024), generator=gen, device=cuda_device) + 0.5
    gamma, beta = torch.ones(64, device=cuda_device), torch.zeros(64, device=cuda_device)
    got = G.group_norm(x, gamma, beta, 4, 1e-6, True)
    want = G._ref(x, gamma, beta, 4, 1e-6, True)
    assert (got - want).abs().max().item() <= 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gpu_attention_bwd_kernel_matches_plain(cuda_device, dtype):
    dt = getattr(torch, dtype)
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    for (b, h, s, d) in [(2, 8, 2048, 32), (2, 4, 1000, 64), (1, 2, 77, 16), (1, 2, 200, 128)]:
        q, k, v, do = (torch.randn((b, h, s, d), generator=gen, device=cuda_device).to(dt)
                       for _ in range(4))
        kb = torch.zeros((b, s), device=cuda_device)
        kb[0, -s // 4:] = -1e9
        o, lse = A._launch(q, k, v, kb, with_lse=True)
        launches = A.flash_attention_bwd.launches
        got = A.flash_attention_bwd(q, k, v, o, do, lse, kb)
        want = A._attend_bwd_ref(q, k, v, o, do, lse, kb)
        torch.cuda.synchronize()
        assert A.flash_attention_bwd.launches == launches + 1
        # f32: summation order only; bf16: P and dS rounded to bf16 on both
        # sides, from exp2 in the kernel and exp in the plain version, and
        # the results rounded to bf16
        for g, w in zip(got, want):
            tol = 1e-4 if dt == torch.float32 else 2e-2 * float(w.float().abs().max())
            assert (g.float() - w.float()).abs().max().item() <= tol


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gpu_attention_tile_edges_match_plain(cuda_device, dtype):
    dt = getattr(torch, dtype)
    gen = torch.Generator(device=cuda_device).manual_seed(6)
    # the tile edges of chip_smoke.py's kernels phase, with fresh inputs
    for (b, h, s, d), fused, masked in ATTN_EDGE_CASES:
        q, k, v, kb = attn_inputs(gen, b, h, s, d, dt, fused, masked)
        o, lse = A._launch(q, k, v, kb, with_lse=True)
        o2, lse2 = A._launch(q, k, v, kb, with_lse=True)
        want = A._attend_ref(q, k, v, kb)
        do = torch.randn(q.shape, generator=gen, device=cuda_device).to(dt)
        got = A.flash_attention_bwd(q, k, v, o, do, lse, kb)
        ref = A._attend_bwd_ref(q, k, v, o, do, lse, kb)
        torch.cuda.synchronize()
        # the tolerances of the tests above; K1 sums in a fixed order
        assert torch.equal(o, o2) and torch.equal(lse, lse2)
        tol = 1e-4 if dt == torch.float32 else 3e-2
        assert (o.float() - want.float()).abs().max().item() <= tol
        lse_ref = A._lse_ref(q, k, kb)
        assert (lse - lse_ref).abs().max().item() <= 2e-4 + 1e-5 * lse_ref.abs().max().item()
        for g, w in zip(got, ref):
            # bf16: chip_smoke.py's 1e-2 + 2e-2 |ref|; at S = 1 dq is ~0 and
            # both sides keep only rounding noise there
            tol = 1e-4 if dt == torch.float32 else 1e-2 + 2e-2 * float(w.float().abs().max())
            assert (g.float() - w.float()).abs().max().item() <= tol


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gpu_attention_bwd_is_deterministic(cuda_device, dtype):
    # dq sums the key blocks' partials in index order; dk and dv in one
    # warp: two launches give the same bits at the training shapes and the
    # tile edges
    dt = getattr(torch, dtype)
    gen = torch.Generator(device=cuda_device).manual_seed(9)
    cases = [((16, 8, 2048, 32), True, False), ((16, 16, 512, 32), True, False),
             ((16, 32, 128, 32), True, False)] + ATTN_EDGE_CASES
    for (b, h, s, d), fused, masked in cases:
        q, k, v, kb = attn_inputs(gen, b, h, s, d, dt, fused, masked)
        o, lse = A._launch(q, k, v, kb, with_lse=True)
        do = torch.randn(q.shape, generator=gen, device=cuda_device).to(dt)
        first = A.flash_attention_bwd(q, k, v, o, do, lse, kb)
        second = A.flash_attention_bwd(q, k, v, o, do, lse, kb)
        torch.cuda.synchronize()
        assert all(torch.equal(x, y) for x, y in zip(first, second)), (b, h, s, d)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gpu_attention_past_65535_batch_heads(cuda_device, dtype):
    # B*H = 70,000 sits on gridDim.x with the tiles, past gridDim.y's limit
    dt = getattr(torch, dtype)
    gen = torch.Generator(device=cuda_device).manual_seed(10)
    q, k, v, _ = attn_inputs(gen, 70000, 1, 16, 32, dt, False, False)
    o, lse = A._launch(q, k, v, None, with_lse=True)
    tol = 1e-4 if dt == torch.float32 else 3e-2
    assert (o.float() - A._attend_ref(q, k, v).float()).abs().max().item() <= tol
    do = torch.randn(q.shape, generator=gen, device=cuda_device).to(dt)
    got = A.flash_attention_bwd(q, k, v, o, do, lse)
    want = A._attend_bwd_ref(q, k, v, o, do, lse)
    for g, w in zip(got, want):
        tol = 1e-4 if dt == torch.float32 else 1e-2 + 2e-2 * float(w.float().abs().max())
        assert (g.float() - w.float()).abs().max().item() <= tol


def _qkv_leaves(t):
    q, k, v = (t[:, :, :, i].transpose(1, 2) for i in range(3))
    return q, k, v


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gpu_gradients_flow_through_attention_and_group_norm(cuda_device, dtype):
    # the kernels' outputs carry a grad_fn, and backward gives the gradients
    # of the plain versions (a ctypes call into a bare torch.empty output
    # would have dropped them)
    dt = getattr(torch, dtype)
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    qkv = torch.randn((2, 300, 4, 3, 32), generator=gen, device=cuda_device).to(dt)
    kb = torch.zeros((2, 300), device=cuda_device)
    kb[1, 250:] = -1e9
    dout = torch.randn((2, 4, 300, 32), generator=gen, device=cuda_device).to(dt)
    grads = []
    for fn in (A.flash_attention, A._attend_ref):
        leaf = qkv.clone().requires_grad_()
        out = fn(*_qkv_leaves(leaf), kb)
        grads.append(torch.autograd.grad(out, leaf, dout)[0])
    tol = 1e-4 if dt == torch.float32 else 2e-2
    assert (grads[0].float() - grads[1].float()).abs().max().item() <= tol

    x = (torch.randn((2, 256, 16, 128), generator=gen, device=cuda_device) * 2 + 0.3).to(dt)
    gamma = 1 + 0.1 * torch.randn(256, generator=gen, device=cuda_device)
    beta = 0.1 * torch.randn(256, generator=gen, device=cuda_device)
    dy = torch.randn(x.shape, generator=gen, device=cuda_device).to(dt)
    for act in (False, True):
        res = []
        for fn in (G.group_norm, G._ref):
            leaves = [t.clone().requires_grad_() for t in (x, gamma, beta)]
            res.append(torch.autograd.grad(fn(*leaves, 32, 1e-6, act), leaves, dy))
        for got, want, tol in zip(*res, (1e-4 if dt == torch.float32 else 3e-2, 1e-2, 1e-2)):
            assert got.dtype == want.dtype
            assert (got.float() - want.float()).abs().max().item() <= tol


@pytest.mark.gpu
def test_gpu_autocast_dtype_cases(cuda_device):
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    q, k, v = (torch.randn((2, 4, 128, 32), generator=gen, device=cuda_device)
               for _ in range(3))
    # K1 takes one dtype: mixed q/k/v raise outside autocast, and run in the
    # autocast dtype inside it, with gradients back in each input's dtype
    with pytest.raises(TypeError):
        A.flash_attention(q.bfloat16(), k, v)
    qb = q.bfloat16().requires_grad_()
    kf, vf = k.clone().requires_grad_(), v.clone().requires_grad_()
    with torch.autocast("cuda", dtype=torch.bfloat16):
        out = A.flash_attention(qb, kf, vf)
    assert out.dtype == torch.bfloat16
    out.float().square().sum().backward()
    assert qb.grad.dtype == torch.bfloat16 and kf.grad.dtype == torch.float32
    want = A._attend_ref(q.bfloat16(), k.bfloat16(), v.bfloat16())
    assert (out.float() - want.float()).abs().max().item() <= 3e-2

    # K3 with bf16 activations and f32 affines that require grad
    x = torch.randn((2, 64, 8, 16), generator=gen, device=cuda_device).bfloat16()
    x.requires_grad_()
    gamma = torch.ones(64, device=cuda_device, requires_grad=True)
    beta = torch.zeros(64, device=cuda_device, requires_grad=True)
    with torch.autocast("cuda", dtype=torch.bfloat16):
        y = G.group_norm(x, gamma, beta, 32, 1e-6, True)
    assert y.dtype == torch.bfloat16
    y.float().sum().backward()
    assert x.grad.dtype == torch.bfloat16 and gamma.grad.dtype == torch.float32
    assert torch.isfinite(beta.grad).all()


@pytest.mark.gpu
def test_gpu_tiny_training_step_under_autocast(cuda_device):
    # f32 weights, bf16 autocast: the embedding adds mix the bf16 Linear
    # output with bf16 activations, the norms take f32 affines; every U-Net
    # parameter gets a finite gradient through K1, K2 and K3
    from lidar_layout_tpu_torch.flagship import flagship
    from lidar_layout_tpu_torch.train import diffusion_trainer as DT

    model, _ = flagship(tiny=True, device="cuda")
    params = DT.trainable_params(model)
    for p in params.values():   # lift the zero-initialised output layers
        torch.nn.init.normal_(p, std=0.05)
    counts = (A.flash_attention.launches, A.flash_attention_bwd.launches,
              G.group_norm.launches)
    x = torch.rand((2, 16, 128, 1), device=cuda_device) * 2 - 1
    z = model.encode_first_stage(x)
    t = torch.tensor([3, 40], device=cuda_device)
    with torch.autocast("cuda", dtype=torch.bfloat16):
        loss, _ = model.p_losses(z, t, torch.randn_like(z))
    loss.backward()
    torch.cuda.synchronize()
    assert torch.isfinite(loss)
    for name, p in params.items():
        assert p.grad is not None and p.grad.dtype == torch.float32, name
        assert torch.isfinite(p.grad).all(), name
    assert A.flash_attention.launches > counts[0]
    assert A.flash_attention_bwd.launches > counts[1]
    assert G.group_norm.launches > counts[2]


@pytest.mark.gpu
def test_gpu_chamfer_kernel_matches_plain_and_float64(cuda_device):
    from lidar_layout_tpu_torch.ops import chamfer as C

    gen = torch.Generator(device=cuda_device).manual_seed(4)
    y = (torch.rand((4097, 3), generator=gen, device=cuda_device) - 0.5) * 80
    mask = torch.rand(4097, generator=gen, device=cuda_device) < 0.7
    cases = [(y[:13], y[100:177], None), (y[:1000] + 0.5, y, None), (y[:1000] + 0.5, y, mask),
             (y, y, None)]
    for x, yy, m in cases:
        launches = C.nn_dist_one_way.launches
        got = C.nn_dist_one_way(x, yy, m)
        d64 = C._nn_dist_ref(x.double(), yy.double(), m)
        plain = C._nn_dist_ref(x, yy, m)
        torch.cuda.synchronize()
        assert C.nn_dist_one_way.launches == launches + 1
        assert (got >= 0).all()
        # the direct form: a few f32 roundings of d; the plain expansion
        # cancels |x|^2 + |y|^2 in f32
        assert ((got.double() - d64).abs() <= 1e-6 * (1 + d64)).all()
        scale = x.double().square().sum(1) + yy.double().square().sum(1).max()
        assert ((plain.double() - got.double()).abs() <= 16 * 1.2e-7 * scale).all()
    assert (C.nn_dist_one_way(y, y) == 0).all()
    none = torch.zeros(4097, dtype=torch.bool, device=cuda_device)
    assert (C.nn_dist_one_way(y[:100], y, none) == C.BIG).all()


@pytest.mark.gpu
def test_gpu_chamfer_selection_on_adversarial_clouds(cuda_device):
    # the clouds of test_torch_chamfer_select.py, at a few thousand points:
    # float64 within 1e-6 (1 + d), 0 where x lies in y, bit for bit over two
    # launches, and the emulation of both stages gives the same values
    from lidar_layout_tpu_torch.ops import chamfer as C
    from torch_port_helpers import CHAMFER_CLOUDS, chamfer_cloud

    for name in sorted(CHAMFER_CLOUDS):
        x, y = (torch.from_numpy(a).to(cuda_device) for a in chamfer_cloud(name, 3000, 4))
        got = C.nn_dist_one_way(x, y)
        again = C.nn_dist_one_way(x, y)
        d64 = C._nn_dist_ref(x.double(), y.double())
        emulated, _ = C._nn_dist_emulated(x, y)
        torch.cuda.synchronize()
        assert torch.equal(got, again), name
        assert ((got.double() - d64).abs() <= 1e-6 * (1 + d64)).all(), name
        assert ((got.double() - emulated.double()).abs() <= 1e-6 * (1 + d64)).all(), name
        if name == "x equal to some y":
            assert (got == 0).all()


@pytest.mark.gpu
def test_gpu_chamfer_grad_guard_raises(cuda_device):
    from lidar_layout_tpu_torch.ops import chamfer as C

    x = torch.rand((64, 3), device=cuda_device, requires_grad=True)
    y = torch.rand((80, 3), device=cuda_device)
    with pytest.raises(RuntimeError, match="forward-only"):
        C.nn_dist_one_way(x, y)
    with pytest.raises(RuntimeError, match="chamfer_loss"):
        C.pairwise_cd(y, x)


@pytest.mark.gpu
def test_gpu_chamfer_loss_and_knn_match_cpu(cuda_device):
    """The object AE's plain-PyTorch point ops on the card: chamfer_loss and
    its gradient against the CPU's (TF32 off; the devices sum in other
    orders), and knn_query's indices on a lattice cloud full of exact ties,
    equal."""
    from lidar_layout_tpu_torch.ops import chamfer as C
    from lidar_layout_tpu_torch.ops import pointops as P

    gen = torch.Generator().manual_seed(3)
    x, y = torch.rand((4, 256, 3), generator=gen), torch.rand((4, 1024, 3), generator=gen)
    grads = {}
    for dev in ("cpu", cuda_device):
        xd, yd = (t.detach().to(dev).requires_grad_() for t in (x, y))
        loss = C.chamfer_loss(xd, yd)
        loss.sum().backward()
        grads[str(dev)] = (loss.detach().cpu(), xd.grad.cpu(), yd.grad.cpu())
    (lc, gxc, gyc), (lg, gxg, gyg) = grads["cpu"], grads[str(cuda_device)]
    torch.testing.assert_close(lg, lc, rtol=1e-5, atol=0)
    for g, c in ((gxg, gxc), (gyg, gyc)):
        assert float((g - c).norm() / c.norm()) <= 1e-4
    lattice = torch.randint(-4, 5, (2, 512, 3), generator=gen).float()
    want = P.knn_query(lattice, lattice, 17)[0]
    got = P.knn_query(lattice.to(cuda_device), lattice.to(cuda_device), 17)[0]
    assert torch.equal(got.cpu(), want)


@pytest.mark.gpu
def test_gpu_rangenet_matches_cpu(cuda_device):
    from lidar_layout_tpu_torch.eval.registry import build_range_feature_net

    torch.backends.cudnn.allow_tf32 = False
    x = torch.randn((2, 64, 1024, 4), generator=torch.Generator().manual_seed(5)) * 5
    feats = []
    for dev in ("cpu", cuda_device):
        net = build_range_feature_net("64", weights_root="/nonexistent", device=dev)
        with torch.inference_mode():
            feats.append(net(x.to(dev), return_final_logits=True).cpu())
    # f32 on both, summed in other orders through 40 convolutions
    rel = (feats[1] - feats[0]).norm() / feats[0].norm()
    assert rel.item() <= 1e-4


def _layout_gn_shapes(dev):
    """(B, C, H, W, groups, act) of every K3 call of the full-width layout
    model: the U-Net at batch 16 and, guided, 32; the VQ decoder at 16."""
    import numpy as np
    from lidar_layout_tpu_torch.flagship import layout_flagship
    from lidar_layout_tpu_torch.nn.blocks import Normalize

    model, _ = layout_flagship(dtype=torch.bfloat16, device=dev)
    seen, batch = set(), {}

    def hook(mod, args):
        _, c, h, w = args[0].shape
        seen.update((b, c, h, w, mod.num_groups, mod.act) for b in batch["b"])

    hooks = [m.register_forward_pre_hook(hook)
             for part in (model.unet, model.first_stage_model.decoder)
             for m in part.modules() if isinstance(m, Normalize)]
    with torch.inference_mode():
        cond = model.get_learned_conditioning(np.zeros((1, 13, 13), np.float32))
        z = torch.zeros((1, 8, 128, 8), device=dev)
        batch["b"] = (16, 32)
        model.apply_model(z, torch.zeros(1, dtype=torch.long, device=dev), cond)
        batch["b"] = (16,)
        model.decode_first_stage(z)
    for hk in hooks:
        hk.remove()
    return sorted(seen)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gpu_group_norm_at_layout_shapes(cuda_device, dtype):
    dt = getattr(torch, dtype)
    gen = torch.Generator(device=cuda_device).manual_seed(9)
    shapes = _layout_gn_shapes(cuda_device)
    # the U-Net's 8x128 latents and concatenated widths, the 32-beam decoder
    assert (16, 2048, 2, 32, 32, True) in shapes and (16, 64, 32, 1024, 32, True) in shapes
    for (b, c, h, w, g, act) in shapes:
        x = (torch.randn((b, c, h, w), generator=gen, device=cuda_device) * 2 + 0.3).to(dt)
        gamma = 1 + 0.1 * torch.randn(c, generator=gen, device=cuda_device)
        beta = 0.1 * torch.randn(c, generator=gen, device=cuda_device)
        launches = G.group_norm.launches
        got = G.group_norm(x, gamma, beta, g, 1e-6, act)
        want = G._ref(x, gamma, beta, g, 1e-6, act)
        torch.cuda.synchronize()
        assert G.group_norm.launches == launches + 1
        # f32: summation order only; bf16: one output rounding (|y| < 8)
        tol = 1e-4 if dt == torch.float32 else 5e-2
        assert (got.float() - want.float()).abs().max().item() <= tol, (b, c, h, w, g, act)


@pytest.mark.gpu
def test_gpu_layout_unet_matches_cpu(cuda_device):
    import numpy as np
    from lidar_layout_tpu_torch.data.synthetic import synthetic_layouts
    from lidar_layout_tpu_torch.flagship import layout_flagship
    from lidar_layout_tpu_torch.ops.lidar import NUSCENES_GEOMETRY
    from torch_port_helpers import seed_weights

    torch.backends.cudnn.allow_tf32 = False
    layouts = np.concatenate([synthetic_layouts(np.random.default_rng(3), 1, NUSCENES_GEOMETRY),
                              np.zeros((1, 13, 13), np.float32)])
    z = torch.randn((2, 8, 32, 8), generator=torch.Generator().manual_seed(4))
    t = torch.tensor([5, 40])
    outs, sd = [], None
    for dev in ("cpu", cuda_device):
        model, _ = layout_flagship(tiny=True, device=dev)
        if sd is None:
            sd = seed_weights(model, 2).state_dict()
        else:
            model.load_state_dict(sd)
        launches = G.group_norm.launches
        with torch.inference_mode():
            cond = model.get_learned_conditioning(layouts)
            outs.append(model.apply_model(z.to(dev), t.to(dev), cond).cpu())
        ran = G.group_norm.launches - launches
    # the card ran every Normalize of the U-Net through K3
    from lidar_layout_tpu_torch.nn.blocks import Normalize
    assert ran == sum(isinstance(m, Normalize) for m in model.unet.modules())
    # f32 on both, summed in other orders through a dozen layers
    assert outs[0].abs().max() > 0.1
    assert (outs[1] - outs[0]).abs().max().item() <= 1e-4 * max(1.0, outs[0].abs().max().item())


@pytest.mark.gpu
def test_gpu_attention_kernel_at_layout_diffusion_shape(cuda_device):
    # LayoutDiffusion's CrossAttentions: (N, 1, 8, 64) projections seen as
    # (N, 8, 1, 64), f32; one query row of a 128-row tile
    gen = torch.Generator(device=cuda_device).manual_seed(11)
    q, k, v = (torch.randn((256, 1, 512), generator=gen, device=cuda_device)
               .reshape(256, 1, 8, 64).transpose(1, 2) for _ in range(3))
    launches = A.flash_attention.launches
    got = A.flash_attention(q, k, v)
    again = A.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert A.flash_attention.launches == launches + 2
    assert (got - A._attend_ref(q, k, v)).abs().max().item() <= 1e-5
    assert torch.equal(got, again)


@pytest.mark.gpu
def test_gpu_attention_bwd_at_layout_diffusion_shape(cuda_device):
    # LayoutDiffusion's training: K2 at (256, 8, 1, 64) f32 on CrossAttention's
    # strides, against the plain version, bit for bit over two launches; one
    # key, so dq and dk are exactly 0, as JAX's
    gen = torch.Generator(device=cuda_device).manual_seed(12)
    q, k, v, do = (torch.randn((256, 1, 512), generator=gen, device=cuda_device)
                   .reshape(256, 1, 8, 64).transpose(1, 2) for _ in range(4))
    o, lse = A._launch(q, k, v, None, with_lse=True)
    launches = A.flash_attention_bwd.launches
    first = A.flash_attention_bwd(q, k, v, o, do, lse)
    second = A.flash_attention_bwd(q, k, v, o, do, lse)
    torch.cuda.synchronize()
    assert A.flash_attention_bwd.launches == launches + 2
    assert all(torch.equal(x, y) for x, y in zip(first, second))
    for got, want in zip(first, A._attend_bwd_ref(q, k, v, o, do, lse)):
        assert (got - want).abs().max().item() <= 1e-4 * max(1.0, want.abs().max().item())
    assert not first[0].any() and not first[1].any()


def _layout_train_gn_shapes(dev):
    """(B, C, H, W, groups, act) of the layout U-Net's K3 calls in a training
    step at batch 16 (each also runs K3's backward)."""
    from lidar_layout_tpu_torch.flagship import layout_flagship
    from lidar_layout_tpu_torch.nn.blocks import Normalize

    model, _ = layout_flagship(device=dev)
    seen = set()
    hooks = [m.register_forward_pre_hook(
        lambda mod, args: seen.add((16, *args[0].shape[1:], mod.num_groups, mod.act)))
        for m in model.unet.modules() if isinstance(m, Normalize)]
    with torch.no_grad():
        cond = model.get_learned_conditioning(torch.zeros((1, 13, 13)))
        model.apply_model(torch.zeros((1, 8, 128, 8), device=dev),
                          torch.zeros(1, dtype=torch.long, device=dev), cond)
    for h in hooks:
        h.remove()
    return sorted(seen)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gpu_group_norm_bwd_at_layout_training_shapes(cuda_device, dtype):
    dt = getattr(torch, dtype)
    gen = torch.Generator(device=cuda_device).manual_seed(12)
    shapes = _layout_train_gn_shapes(cuda_device)
    assert (16, 256, 8, 128, 32, True) in shapes and (16, 2048, 2, 32, 32, True) in shapes
    for (b, c, h, w, g, act) in shapes:
        x = (torch.randn((b, c, h, w), generator=gen, device=cuda_device) * 2 + 0.3).to(dt)
        gamma = 1 + 0.1 * torch.randn(c, generator=gen, device=cuda_device)
        beta = 0.1 * torch.randn(c, generator=gen, device=cuda_device)
        dy = torch.randn(x.shape, generator=gen, device=cuda_device).to(dt)
        launches = G.group_norm_bwd.launches
        got = G.group_norm_bwd(x, gamma, beta, dy, g, 1e-6, act)
        again = G.group_norm_bwd(x, gamma, beta, dy, g, 1e-6, act)
        want = G._group_norm_bwd_ref(x, gamma, beta, dy, g, 1e-6, act)
        torch.cuda.synchronize()
        assert G.group_norm_bwd.launches == launches + 2
        assert all(torch.equal(a, b_) for a, b_ in zip(got, again)), (b, c, h, w)
        # both in f32 arithmetic from the same x and dy: dx rounded to x's
        # dtype, dgamma/dbeta sums of B*H*W products
        tol_dx = 1e-4 if dt == torch.float32 else 5e-2
        assert (got[0].float() - want[0].float()).abs().max().item() <= tol_dx, (b, c, h, w)
        for i in (1, 2):
            assert ((got[i] - want[i]).abs().max().item()
                    <= 1e-3 + 1e-4 * want[i].abs().max().item()), (b, c, h, w, i)


@pytest.mark.gpu
def test_gpu_tiny_layout_training_step_under_autocast(cuda_device):
    import numpy as np
    from lidar_layout_tpu_torch.data.synthetic import synthetic_layout_range_batch
    from lidar_layout_tpu_torch.flagship import layout_flagship
    from lidar_layout_tpu_torch.ops.lidar import LidarGeometry
    from lidar_layout_tpu_torch.train import diffusion_trainer as DT
    from torch_port_helpers import seed_weights

    model, _ = layout_flagship(tiny=True, device="cuda")
    seed_weights(model, 3)
    params = DT.trainable_params(model)
    state = DT.create_train_state(model, DT.make_optimizer(params, 1e-4), params)
    batch = synthetic_layout_range_batch(np.random.default_rng(1), 2,
                                         LidarGeometry(size=(32, 256), fov=(10, -30)),
                                         device="cuda")
    grads = {}
    step_opt = state.optimizer.step

    def spy():
        grads.update({k: p.grad for k, p in params.items()})
        return step_opt()
    state.optimizer.step = spy
    before = (A.flash_attention.launches, G.group_norm.launches, G.group_norm_bwd.launches)
    state, logs = DT.make_train_step(model, autocast_dtype=torch.bfloat16)(
        state, batch, torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    assert torch.isfinite(logs["loss"]) and torch.isfinite(logs["grad_norm"])
    for name, g in grads.items():
        assert g is not None and g.dtype == torch.float32 and torch.isfinite(g).all(), name
    enc = [g for k, g in grads.items() if k.startswith("cond_stage_model.")]
    assert enc and sum(float(g.abs().sum()) for g in enc) > 0
    # K3 forward and backward; the object-aware attention is plain matmuls
    assert A.flash_attention.launches == before[0]
    assert G.group_norm.launches > before[1] and G.group_norm_bwd.launches > before[2]


@pytest.mark.gpu
def test_gpu_tiny_layout_diffusion_matches_cpu(cuda_device):
    import numpy as np
    from lidar_layout_tpu_torch.data.layout_synthetic import synthetic_graph_batch
    from lidar_layout_tpu_torch.models.layout_diffusion import (LayoutDiffusion,
                                                                LayoutDiffusionConfig)
    from lidar_layout_tpu_torch.models.unet1d import UNet1DConfig
    from lidar_layout_tpu_torch.nn.attention import CrossAttention
    from torch_port_helpers import seed_weights

    torch.backends.cudnn.allow_tf32 = False
    graph = synthetic_graph_batch(np.random.default_rng(2), n_scenes=2, max_objs_per_scene=4,
                                  max_triples_per_scene=6)
    x_T = torch.randn((8, 8), generator=torch.Generator().manual_seed(3))
    outs, sd = [], None
    for dev in ("cpu", cuda_device):
        model = LayoutDiffusion(LayoutDiffusionConfig(), UNet1DConfig(
            model_channels=64, concat_dim=96, crossattn_dim=96), sg_embedding_dim=16).to(dev)
        if sd is None:
            sd = seed_weights(model, 4).state_dict()
        else:
            model.load_state_dict(sd)
        launches = A.flash_attention.launches
        outs.append(model.ddim_sample(graph, steps=4, x_T=x_T).cpu())
        ran = A.flash_attention.launches - launches
    # every CrossAttention of the 4 U-Net evals went to K1 on the card
    assert ran == 4 * sum(isinstance(m, CrossAttention) for m in model.unet.modules()) > 0
    # f32 on both, summed in other orders; DDIM-4 amplifies the differences
    assert outs[0].abs().max() > 0.1
    assert (outs[1] - outs[0]).abs().max().item() <= 1e-3 * max(1.0, outs[0].abs().max().item())


def _ae_step_norm_shapes(dev):
    """K3's (forward, backward) calls of one training step of the full-width
    kitti autoencoder (batch 4) and its discriminator, by shape, from hooks."""
    import numpy as np
    from lidar_layout_tpu_torch.config import instantiate_from_config, load_yaml
    from lidar_layout_tpu_torch.data.synthetic import synthetic_range_batch
    from lidar_layout_tpu_torch.losses.discriminator import LiDARNLayerDiscriminator
    from lidar_layout_tpu_torch.losses.geometric import GeoConverter
    from lidar_layout_tpu_torch.pipeline import geometry_from_config
    from lidar_layout_tpu_torch.train import ae_trainer as AT
    from torch_port_helpers import count_group_norms

    import os

    cfg = load_yaml(os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                 "configs", "autoencoder", "kitti", "autoencoder_c2_p4.yaml"))
    loss_cfg = instantiate_from_config(cfg["model"]["params"]["lossconfig"])
    geom = geometry_from_config(cfg)
    geo = GeoConverter(geom, curve_length=loss_cfg.curve_length)
    model = instantiate_from_config(cfg["model"]).to(dev)
    disc = LiDARNLayerDiscriminator(AT.disc_in_channels(1, loss_cfg, geo)).to(dev)
    batch = synthetic_range_batch(np.random.default_rng(0), 4, geom, device=dev)
    with count_group_norms(model, disc) as shapes:
        AT.make_ae_train_step(model, disc, loss_cfg, geo)(
            AT.create_ae_state(model, disc, 1e-5, 1e-5), batch, torch.Generator(device=dev))
    return shapes


@pytest.mark.gpu
def test_gpu_group_norm_at_ae_training_shapes(cuda_device):
    """K3 forward and backward in f32 at every group shape of the
    autoencoder's training step (eps 1e-6; 1e-5 in the discriminator),
    against the plain versions; the backward bit for bit over two launches."""
    gen = torch.Generator(device=cuda_device).manual_seed(13)
    fwd, bwd = _ae_step_norm_shapes(cuda_device)
    assert sum(fwd.values()) == 52 + 9 and sum(bwd.values()) == 52 + 12
    assert (4, 64, 64, 1024, 32, True, 1e-6) in fwd and (4, 512, 64, 128, 32, False, 1e-5) in bwd
    for (b, c, h, w, g, act, eps) in sorted(set(fwd) | set(bwd)):
        x = torch.randn((b, c, h, w), generator=gen, device=cuda_device) * 2 + 0.3
        gamma = 1 + 0.1 * torch.randn(c, generator=gen, device=cuda_device)
        beta = 0.1 * torch.randn(c, generator=gen, device=cuda_device)
        dy = torch.randn(x.shape, generator=gen, device=cuda_device)
        got = G.group_norm(x, gamma, beta, g, eps, act)
        want = G._ref(x, gamma, beta, g, eps, act)
        assert (got - want).abs().max().item() <= 1e-4 + 1e-5 * want.abs().max().item()
        grads = G.group_norm_bwd(x, gamma, beta, dy, g, eps, act)
        again = G.group_norm_bwd(x, gamma, beta, dy, g, eps, act)
        ref = G._group_norm_bwd_ref(x, gamma, beta, dy, g, eps, act)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b_) for a, b_ in zip(grads, again)), (b, c, h, w)
        # both in f32 from the same x and dy; dgamma/dbeta sum B*H*W products
        assert (grads[0] - ref[0]).abs().max().item() <= 1e-4, (b, c, h, w)
        for i in (1, 2):
            assert ((grads[i] - ref[i]).abs().max().item()
                    <= 1e-3 + 1e-4 * ref[i].abs().max().item()), (b, c, h, w, i)


@pytest.mark.gpu
def test_gpu_tiny_ae_step_matches_cpu(cuda_device):
    """One VQ-GAN step of a tiny autoencoder (ch 16, 16x64 images, the mask
    head and the geometric term) on the card and on the CPU from the same
    weights: the reconstruction loss, the discriminator's loss and the
    parameters after Adam; K3 ran forward and backward on the card."""
    import numpy as np
    from lidar_layout_tpu_torch.losses.discriminator import LiDARNLayerDiscriminator
    from lidar_layout_tpu_torch.losses.geometric import GeoConverter
    from lidar_layout_tpu_torch.losses.vq_loss import VQLossConfig
    from lidar_layout_tpu_torch.models.autoencoder import AEConfig, VQModel
    from lidar_layout_tpu_torch.ops.lidar import LidarGeometry
    from lidar_layout_tpu_torch.train import ae_trainer as AT
    from torch_port_helpers import seed_weights

    torch.backends.cudnn.allow_tf32 = False
    cfg = VQLossConfig(mask_factor=1.0, geo_factor=1.0, curve_length=1)
    geo = GeoConverter(LidarGeometry(size=(16, 64)), curve_length=1)
    x = np.clip(np.random.default_rng(1).standard_normal((2, 16, 64, 1)) * 0.3, -1, 1)
    batch = {"image": torch.tensor(x, dtype=torch.float32), "mask": torch.ones(2, 16, 64, 1)}
    out = []
    for dev in ("cpu", cuda_device):
        model = seed_weights(VQModel(AEConfig(ch=16, ch_mult=(1, 2), strides=((1, 2),),
                                              z_channels=4, out_ch=2, num_res_blocks=1),
                                     n_embed=64, embed_dim=4, use_mask=True), 5).to(dev)
        disc = seed_weights(LiDARNLayerDiscriminator(4, ndf=16, n_layers=2), 6).to(dev)
        state = AT.create_ae_state(model, disc, 1e-3, 1e-3)
        grads = []

        def spy(gs, real=state.opt_g.step):
            grads.extend(g.detach().cpu().flatten() for g in gs)
            return real(gs)
        state.opt_g.step = spy
        before = (G.group_norm.launches, G.group_norm_bwd.launches)
        _, logs = AT.make_ae_train_step(model, disc, cfg, geo)(
            state, {k: v.to(dev) for k, v in batch.items()}, torch.Generator(device=dev))
        ran = (G.group_norm.launches - before[0], G.group_norm_bwd.launches - before[1])
        out.append((float(logs["rec_loss"]), float(logs["disc_loss"]),
                    torch.cat([p.detach().cpu().flatten() for p in model.parameters()]),
                    torch.cat(grads)))
    # f32 on both, TF32 off, sums in other orders; Adam's first update is
    # about lr * sign(g), which flips where g is within rounding of 0. The
    # share check leaves out elements whose CPU gradient is zero to rounding
    # (under 1e-6 of the largest: the biases that a GroupNorm with one
    # channel a group removes), which both sides step by lr * sign(noise)
    assert abs(out[1][0] - out[0][0]) <= 1e-5 * abs(out[0][0])
    assert abs(out[1][1] - out[0][1]) <= 1e-5 * abs(out[0][1])
    diff = (out[1][2] - out[0][2]).abs()
    assert diff.max().item() <= 2e-3
    live = out[0][3].abs() > 1e-6 * out[0][3].abs().max()
    assert int((diff[live] > 0.01 * 1e-3).sum()) <= 1e-3 * int(live.sum())
    # 24 autoencoder norms forward and backward; the discriminator's 2 norms
    # forward 3 times and backward 4 times (ae_trainer's step)
    assert ran == (24 + 3 * 2, 24 + 4 * 2)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["MinkowskiNet", "SPVCNN"])
def test_gpu_voxel_nets_match_cpu(cuda_device, arch):
    """MinkowskiNet / SPVCNN at cr 0.5 and 4096 level-0 voxels on two clouds
    past 1023 cells: the grid pyramid equal integer for integer, the
    descriptors within 1e-4 relative L2 of the CPU's (f32, TF32 off)."""
    from lidar_layout_tpu_torch.eval import sparse_seg_nets as S
    from lidar_layout_tpu_torch.eval.voxel_nets import depth_sector_descriptor

    cfg = S.SegNetConfig(cr=0.5, capacity=4096, bits=10)
    gen = torch.Generator().manual_seed(0)
    coords = torch.randint(0, 1500, (2, 3000, 3), generator=gen, dtype=torch.int32)
    coords[..., 2] //= 20
    feats = torch.cat([coords * 0.05, -torch.ones(2, 3000, 1)], -1)
    mask = torch.rand((2, 3000), generator=gen) < 0.9
    torch.manual_seed(0)
    net = getattr(S, arch)(cfg).eval()
    outs, pyramids = {}, {}
    for dev in ("cpu", cuda_device):
        net = net.to(dev)
        args = [t.to(dev) for t in (coords, feats, mask)]
        grids, p2v = S.build_pyramid(args[0], args[2], cfg)
        pyramids[str(dev)] = [t.cpu() for g in grids for t in g] + [p2v.cpu()]
        with torch.no_grad():
            out = net(*args)
            outs[str(dev)] = depth_sector_descriptor(
                (out["coords"].float() * 0.05 if arch == "MinkowskiNet" else args[1][..., :3]),
                out["logits"], out["mask"]).cpu()
    cpu, gpu = outs["cpu"], outs[str(cuda_device)]
    assert all(torch.equal(a, b) for a, b in zip(pyramids["cpu"], pyramids[str(cuda_device)]))
    assert torch.isfinite(gpu).all() and gpu.abs().sum() > 0
    assert float((gpu - cpu).norm() / cpu.norm()) <= 1e-4


def _cube_clouds(n_points=600, seed=0):
    """Two clouds: one within 64 cells of 0.5 m, one spread past 128."""
    gen = torch.Generator().manual_seed(seed)
    pts = torch.stack([torch.rand((n_points, 3), generator=gen) * 2 - 1,
                       torch.rand((n_points, 3), generator=gen) * 80 - 40])
    feats = torch.cat([pts, torch.rand((2, n_points, 1), generator=gen)], -1)
    mask = torch.ones((2, n_points), dtype=torch.bool)
    mask[:, -50:] = False
    return {"points": pts, "feats": feats, "mask": mask}


_CUBE_AE = {"target": "cube_ae", "params": {
    "base_capacity": 128, "geoconfig": {"voxel_size": 0.5, "tree_depth": 3},
    "unetconfig": {"params": {"f_maps": 8, "cut_ratio": 16}}}}
_CUBE_LDM = {"target": "cube_latent_diffusion", "params": {
    "unet_config": {"params": {"model_channels": 16, "num_res_blocks": 2, "num_heads": 2}},
    "first_stage_config": _CUBE_AE}}


def _rel(a, b):
    return float((a.detach().cpu() - b.detach().cpu()).norm() / b.detach().cpu().norm())


@pytest.mark.gpu
def test_gpu_sparse_vae_matches_cpu(cuda_device):
    """The cube stage's SparseVAE on the card and on the CPU from the same
    weights and latent draw: every grid, the occupancy targets and the
    point-to-voxel map equal; the latent, the struct logits, struct_loss and
    the gradients within 1e-5 relative (f32, TF32 off; the scatter-means'
    atomics reorder sums)."""
    from lidar_layout_tpu_torch.config import instantiate_from_config
    from lidar_layout_tpu_torch.models.sparse_vae import struct_loss
    from lidar_layout_tpu_torch.ops import voxel as V

    clouds = _cube_clouds()
    torch.manual_seed(0)
    vae = instantiate_from_config(_CUBE_AE)
    noise = torch.randn((2, 32, vae.cfg.latent_dim), generator=torch.Generator().manual_seed(1))
    outs = {}
    for dev in ("cpu", cuda_device):
        vae = vae.to(dev)
        vae.zero_grad()
        b = {k: v.to(dev) for k, v in clouds.items()}
        out = vae(b["points"], b["feats"], b["mask"], noise=noise.to(dev))
        loss, _ = struct_loss(out, vae.cfg.kl_weight)
        loss.mean().backward()
        _, p2v, _ = V.voxelize_points(b["points"], b["mask"], 0.5, 128)
        outs[str(dev)] = (out, loss, p2v, [p.grad.detach().cpu().clone() if p.grad is not None
                                           else torch.zeros(p.shape) for p in vae.parameters()])
    (oc, lc, pc, gc), (og, lg, pg, gg) = outs["cpu"], outs[str(cuda_device)]
    ints = [a for g in oc["grids"] for a in g] + oc["struct_targets"] + [pc]
    ints_g = [a for g in og["grids"] for a in g] + og["struct_targets"] + [pg]
    assert all(torch.equal(a, b.cpu()) for a, b in zip(ints, ints_g))
    assert _rel(og["latent"], oc["latent"]) <= 1e-5
    assert all(_rel(a, b) <= 1e-5 for a, b in zip(og["struct_logits"], oc["struct_logits"]))
    assert _rel(lg, lc) <= 1e-5
    assert _rel(torch.cat([g.flatten() for g in gg]), torch.cat([g.flatten() for g in gc])) <= 1e-5


@pytest.mark.gpu
def test_gpu_cube_diffusion_and_trainer_step_match_cpu(cuda_device):
    """CubeDiffusion's p_losses (fed t and noise) and DDIM-3 (fed x_T) on
    the card and the CPU within 1e-5 relative, and one step of each cube
    family trainer: losses within 1e-5 relative, parameters after AdamW
    within 2 lr."""
    from lidar_layout_tpu_torch.config import instantiate_from_config
    from lidar_layout_tpu_torch.ops.voxel import VoxelGrid
    from lidar_layout_tpu_torch.train import cube_trainer as CT

    clouds = _cube_clouds(seed=2)
    gen = torch.Generator().manual_seed(3)
    torch.manual_seed(0)
    ref = instantiate_from_config(_CUBE_LDM)
    with torch.no_grad():
        for p in ref.unet.parameters():   # lift the zero-initialised proj and out
            if not p.any():
                torch.nn.init.normal_(p, std=0.05)
    sd = ref.state_dict()
    with torch.no_grad():
        out = ref.first_stage_model(clouds["points"], clouds["feats"], clouds["mask"],
                                    noise=torch.zeros(2, 32, 4))
    grid, z = VoxelGrid(*out["latent_grid"]), out["latent"]
    t, eps, x_t = torch.tensor([5, 800]), torch.randn(z.shape, generator=gen), torch.randn(
        z.shape, generator=gen)
    lat_noise = torch.randn(z.shape, generator=gen)
    res = {}
    for dev in ("cpu", cuda_device):
        model = instantiate_from_config(_CUBE_LDM)
        model.load_state_dict(sd)
        model = model.to(dev)
        g = VoxelGrid(*(a.to(dev) for a in grid))
        with torch.no_grad():
            loss, _ = model.p_losses(g, z.to(dev), t=t.to(dev), noise=eps.to(dev))
            zs = model.ddim_sample(g, steps=3, x_T=x_t.to(dev))
        b = {k: v.to(dev) for k, v in clouds.items()}
        state, step, _, _ = CT.cube_training(model, _CUBE_LDM, 1e-3)
        state, logs = step(state, b, None, latent_noise=lat_noise.to(dev), t=t.to(dev),
                           noise=eps.to(dev))
        vae = model.first_stage_model
        vstate, vstep, _, _ = CT.cube_training(vae.requires_grad_(True), _CUBE_AE, 1e-3)
        vstate, vlogs = vstep(vstate, b, None, noise=lat_noise.to(dev))
        res[str(dev)] = (loss, zs, float(logs["loss"]), float(vlogs["loss"]),
                         torch.cat([p.detach().cpu().flatten() for p in model.parameters()]))
    c, g = res["cpu"], res[str(cuda_device)]
    assert _rel(g[0], c[0]) <= 1e-5 and _rel(g[1], c[1]) <= 1e-5
    assert abs(g[2] - c[2]) <= 1e-5 * abs(c[2]) and abs(g[3] - c[3]) <= 1e-5 * abs(c[3])
    assert float((g[4] - c[4]).abs().max()) <= 2e-3


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gpu_kernels_at_the_coarse_shapes(cuda_device, dtype):
    """K1 and K2 at the coarse LiDM's attention shapes (S = 128, 32 and 8,
    head 32) and K3 forward and backward at its U-Net's and AE's group
    shapes (4x32 to 1x8, 8x256), against the plain versions."""
    dt = getattr(torch, dtype)
    gen = torch.Generator(device=cuda_device).manual_seed(4)
    tol = 1e-4 if dt == torch.float32 else 3e-2
    for (b, h, s, d) in [(2, 4, 128, 32), (2, 8, 32, 32), (2, 8, 8, 32)]:
        q, k, v, _ = attn_inputs(gen, b, h, s, d, dt, False, False)
        o, lse = A._launch(q, k, v, None, with_lse=True)
        assert (o.float() - A._attend_ref(q, k, v).float()).abs().max().item() <= tol
        do = torch.randn(q.shape, generator=gen, device=cuda_device).to(dt)
        for g_, w_ in zip(A.flash_attention_bwd(q, k, v, o, do, lse),
                          A._attend_bwd_ref(q, k, v, o, do, lse)):
            assert (g_.float() - w_.float()).abs().max().item() <= tol * max(
                1.0, w_.float().abs().max().item())
    for (b, c, hh, ww) in [(2, 128, 4, 32), (2, 256, 2, 16), (2, 256, 1, 8), (2, 64, 8, 256)]:
        x = (torch.randn((b, c, hh, ww), generator=gen, device=cuda_device) * 2 + 0.3).to(dt)
        gamma = 1 + 0.1 * torch.randn(c, generator=gen, device=cuda_device)
        beta = 0.1 * torch.randn(c, generator=gen, device=cuda_device)
        dy = torch.randn(x.shape, generator=gen, device=cuda_device).to(dt)
        for act in (False, True):
            got = G.group_norm(x, gamma, beta, 32, 1e-6, act)
            assert (got.float() - G._ref(x, gamma, beta, 32, 1e-6, act).float()).abs().max() \
                .item() <= (1e-4 if dt == torch.float32 else 3e-2)
            for g_, w_ in zip(G.group_norm_bwd(x, gamma, beta, dy, 32, 1e-6, act),
                              G._group_norm_bwd_ref(x, gamma, beta, dy, 32, 1e-6, act)):
                assert (g_.float() - w_.float()).abs().max().item() <= 1e-3 * max(
                    1.0, w_.float().abs().max().item()) + (0 if dt == torch.float32 else 2e-2)


@pytest.mark.gpu
def test_gpu_eval_ae_and_log_images_match_cpu(cuda_device):
    """eval_ae's reconstruction of a tiny mask-head AE and the image
    logger's suite on the tiny flagship, card against CPU from the same
    weights and draws (the ray-drop decision in 99.9% agreement, kept
    pixels within 1e-3)."""
    from lidar_layout_tpu_torch import eval_ae as EA
    from lidar_layout_tpu_torch.flagship import flagship
    from lidar_layout_tpu_torch.models import samplers as S
    from lidar_layout_tpu_torch.models.autoencoder import AEConfig, VQModel
    from lidar_layout_tpu_torch.train.sample_logger import lidm_log_images
    from torch_port_helpers import seed_weights

    torch.backends.cudnn.allow_tf32 = False
    x = torch.rand((2, 16, 64, 1), generator=torch.Generator().manual_seed(5)) * 2 - 1
    ae = seed_weights(VQModel(AEConfig(ch=16, ch_mult=(1, 2), strides=((1, 2),), z_channels=4,
                                       out_ch=2, num_res_blocks=1), n_embed=64, embed_dim=4,
                              use_mask=True), 7).eval()
    rec = {str(dev): EA.reconstruct(ae.to(dev), x.to(dev)).cpu() for dev in ("cpu", cuda_device)}
    port, image_shape = flagship(tiny=True, device="cpu")
    seed_weights(port, 8)
    draws = [torch.randn((2, *port.cfg.latent_shape), generator=torch.Generator().manual_seed(i))
             for i in range(40)]
    imgs, real = {}, S._randn
    img = torch.rand((2, *image_shape), generator=torch.Generator().manual_seed(9)) * 2 - 1
    for dev in ("cpu", cuda_device):
        pool = list(draws)
        S._randn = lambda shape, gen, d, pool=pool: pool.pop(0).to(d)
        try:
            imgs[str(dev)] = {k: v.cpu() for k, v in lidm_log_images(
                port.to(dev), {"image": img.to(dev)}, None, n_row=2, sample_steps=3).items()}
        finally:
            S._randn = real
    pairs = [(rec[str(cuda_device)], rec["cpu"])] + [
        (imgs[str(cuda_device)][k], imgs["cpu"][k]) for k in imgs["cpu"]]
    for g_, c_ in pairs:
        drop_g, drop_c = g_ == -1.0, c_ == -1.0
        assert (drop_g == drop_c).float().mean() >= 0.999
        both = ~drop_g & ~drop_c
        assert (g_ - c_).abs()[both].max().item() <= 1e-3


@pytest.mark.gpu
def test_gpu_attention_at_the_conditional_unet_f32_shapes(cuda_device):
    # the conditional U-Net's self-attention in f32 (map2lidar's
    # SelfAttentionBlocks, cam2lidar's and text2lidar's SpatialTransformer
    # attn1) at batch 4, and 8 under classifier-free guidance: K1 against its
    # plain version, bit for bit over two launches
    gen = torch.Generator(device=cuda_device).manual_seed(14)
    for (b, h, s, d) in [(4, 8, 2048, 32), (4, 16, 512, 32), (4, 32, 128, 32),
                         (8, 8, 2048, 32), (8, 32, 128, 32)]:
        q, k, v = (torch.randn((b, h, s, d), generator=gen, device=cuda_device)
                   for _ in range(3))
        got = A.flash_attention(q, k, v)
        again = A.flash_attention(q, k, v)
        want = A._attend_ref(q, k, v)
        torch.cuda.synchronize()
        assert torch.equal(got, again)
        assert (got - want).abs().max().item() <= 2e-5 + 1e-4 * want.abs().max().item()


@pytest.mark.gpu
def test_gpu_map2lidar_request_is_finite_and_of_the_cli_shape(cuda_device, tmp_path):
    import numpy as np

    from lidar_layout_tpu_torch import sample_cond
    from lidar_layout_tpu_torch.models.schedules import DDIMSchedule

    launches = A.flash_attention.launches, G.group_norm.launches
    out = sample_cond.main(["--task", "map2lidar", "-n", "2", "--steps", "3",
                            "--outdir", str(tmp_path)])
    saved = np.load(tmp_path / "map2lidar_samples.npy")
    assert saved.shape == (2, 64, 1024, 1) and np.isfinite(saved).all()
    # 16 self-attentions a U-Net eval (ds 4, 2, 1 over 2 + 1 + 3 blocks a
    # level); K3 in 17 ResBlocks (two norms each), the 16 attention norms and
    # norm_out: 51 an eval, and the decoder's besides
    from lidar_layout_tpu_torch.nn.blocks import Normalize

    model = out["model"]
    evals = len(DDIMSchedule.create(model.schedule, 3).timesteps)
    assert sum(isinstance(m, Normalize) for m in model.unet.modules()) == 51
    dec_norms = sum(isinstance(m, Normalize) for m in model.first_stage_model.decoder.modules())
    assert A.flash_attention.launches - launches[0] == 16 * evals
    assert G.group_norm.launches - launches[1] == 51 * evals + dec_norms
