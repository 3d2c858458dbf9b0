"""Port parity: CAM++ (module path, fused path, K2's plain twin) against JAX."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speaker_diarization_tpu.kernels import cam_block_fused as JFused
from speaker_diarization_tpu.kernels.cam_block_pallas import cam_dense_block_pallas
from speaker_diarization_tpu.models.campplus import CAMDenseTDNNBlock as JBlock
from speaker_diarization_tpu.models.campplus import CAMPPlus as JCAMPPlus
from speaker_diarization_tpu.utils.torch_convert import campplus_torch_to_flax
from speaker_diarization_tpu_torch.kernels import cam_block as K2
from speaker_diarization_tpu_torch.kernels import cam_block_fused as TFused
from speaker_diarization_tpu_torch.models.campplus import CAMPPlus, seg_pooling
from speaker_diarization_tpu_torch.models.layers import init_weights_
from speaker_diarization_tpu_torch.utils.convert import campplus_from_flax

torch.set_num_threads(1)


def _perturb_stats(variables, seed=0):
    """Non-trivial running statistics (init leaves mean 0 / var 1)."""
    rng = np.random.default_rng(seed)
    stats = jax.tree_util.tree_map(
        lambda v: np.asarray(v) + 0.1 * np.abs(rng.standard_normal(v.shape)).astype(np.float32),
        variables["batch_stats"],
    )
    return {"params": variables["params"], "batch_stats": stats}


def _jax_block_params(C0, L, dilation, seed):
    block = JBlock(num_layers=L, out_channels=32, bn_channels=128, kernel_size=3, dilation=dilation)
    x0 = jnp.zeros((1, 200, C0), jnp.float32)
    v = _perturb_stats(block.init(jax.random.PRNGKey(seed), x0, False), seed)
    bp = JFused.prepare_block_params(v["params"], v["batch_stats"], L, C0, C0 + 32 * L)
    return block, v, bp


def _to_torch(bp):
    return {k: torch.from_numpy(np.array(v)) for k, v in bp.items()}


class TestBlockTwin:
    @pytest.mark.parametrize("T", [199, 200])
    @pytest.mark.parametrize("dilation", [1, 2])
    def test_matches_jax_cam_dense_block_infer(self, T, dilation):
        B, C0, L = 2, 64, 3
        _, _, bp = _jax_block_params(C0, L, dilation, seed=T + dilation)
        x = np.random.default_rng(T).standard_normal((B, T, C0)).astype(np.float32)
        jit_block = jax.jit(JFused.cam_dense_block_infer, static_argnums=2, static_argnames="dtype")
        ref = np.asarray(jit_block(jnp.asarray(x), bp, dilation, dtype=jnp.float32))
        got = K2.cam_dense_block_infer(torch.from_numpy(x), _to_torch(bp), dilation, dtype=torch.float32)
        np.testing.assert_allclose(got.numpy(), ref, atol=2e-4)

    def test_matches_pallas_interpret(self):
        B, T, C0, L, dil = 2, 200, 64, 3, 2
        _, _, bp = _jax_block_params(C0, L, dil, seed=5)
        x = np.random.default_rng(5).standard_normal((B, T, C0)).astype(np.float32)
        ref = np.asarray(cam_dense_block_pallas(jnp.asarray(x), bp, dil, dtype=jnp.float32, interpret=True))
        got = K2.cam_dense_block_infer(torch.from_numpy(x), _to_torch(bp), dil, dtype=torch.float32)
        np.testing.assert_allclose(got.numpy(), ref, atol=2e-5, rtol=2e-5)

    def test_wrapper_on_cpu_is_the_twin(self):
        _, _, bp = _jax_block_params(64, 2, 1, seed=1)
        x = torch.from_numpy(np.random.default_rng(1).standard_normal((1, 150, 64)).astype(np.float32))
        launches = K2.cam_dense_block_cuda.launches
        a = K2.cam_dense_block_cuda(x, _to_torch(bp), 1)
        b = K2.cam_dense_block_infer(x, _to_torch(bp), 1, dtype=torch.float32)
        torch.testing.assert_close(a, b, rtol=0, atol=0)
        assert K2.cam_dense_block_cuda.launches == launches

    @pytest.mark.parametrize("c0", [44, 97])
    def test_padded_input_width_is_the_block(self, c0):
        # the bf16 kernel runs widths that are not a multiple of 8 with zero
        # channels after x (pad_input_width); the block's function is unchanged
        L, p = 2, -c0 % 8
        _, _, bp = _jax_block_params(c0, L, 2, seed=c0)
        bp = _to_torch(bp)
        x = torch.from_numpy(np.random.default_rng(c0).standard_normal((2, 130, c0)).astype(np.float32))
        padded = K2.cam_dense_block_infer(
            torch.nn.functional.pad(x, (0, p)), K2.pad_input_width(bp, c0, p), 2, dtype=torch.float32)
        assert padded.shape[-1] == c0 + p + 32 * L and not padded[..., c0 : c0 + p].any()
        got = torch.cat([padded[..., :c0], padded[..., c0 + p :]], dim=-1)
        torch.testing.assert_close(got, K2.cam_dense_block_infer(x, bp, 2, dtype=torch.float32), rtol=0, atol=2e-6)

    def test_prepare_block_params_matches_jax(self):
        C0, L = 64, 3
        model = CAMPPlus(block_layers=(L,), block_dilations=(1,), init_channels=C0)
        init_weights_(model, torch.Generator().manual_seed(0))
        params, stats = campplus_torch_to_flax(model.state_dict())
        ref = JFused.prepare_block_params(params["block1"], stats["block1"], L, C0, C0 + 32 * L)
        got = TFused.prepare_block_params(model.xvector.block1, C0, C0 + 32 * L)
        for k in ref:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), atol=1e-6, err_msg=k)

    def test_seg_pooling_ceil_tail(self):
        x = np.random.default_rng(2).standard_normal((2, 250, 3)).astype(np.float32)
        from speaker_diarization_tpu.models.campplus import seg_pooling as jseg

        np.testing.assert_allclose(seg_pooling(torch.from_numpy(x)).numpy(), np.asarray(jseg(jnp.asarray(x))), atol=1e-6)

    def test_work_counts(self):
        # flagship block 3: c0 512, 16 layers -> live-channel work ~44 GFLOP at B=64, T=199
        w = K2.cam_block_work(64, 199, 512, 16)
        assert 40e9 < w["flops"] < 48e9
        assert w["bytes"] > 2 * 64 * 199 * (512 + 1024)


def _split_block(x, bp, d, cl, seg_len=100):
    """The bf16 kernel's decomposition of one dense block in plain fp32 torch:
    cl CTAs owning frames [r·tc, min(T, (r+1)·tc)); each projects its own
    frames, sums them per segment (four row quarters added in order, then the
    segments in order), the cluster's sums are added in rank order, and the
    conv reads the dil-frame halo of u from the neighbours (zeros outside
    [0, T))."""
    B, T, c0 = x.shape
    L, c_max = bp["W1"].shape[:2]
    tc = -(-T // cl)
    ranges = [(r * tc, min(T, (r + 1) * tc)) for r in range(cl)]
    assert all(t0 < t1 for t0, t1 in ranges)
    buf = torch.zeros((B, T, c_max))
    buf[..., :c0] = x
    for i in range(L):
        c_in = c0 + 32 * i
        us, parts = [], []
        for t0, t1 in ranges:
            h = torch.relu(buf[:, t0:t1, :c_in] * bp["s1"][i, :c_in] + bp["b1"][i, :c_in])
            u = torch.relu((h @ bp["W1"][i, :c_in]) * bp["s2"][i] + bp["b2"][i])
            ps = {}
            for S in range(t0 // seg_len, (t1 - 1) // seg_len + 1):
                lo, hi = max(t0, S * seg_len) - t0, min(t1, (S + 1) * seg_len) - t0
                q = [u[:, lo + (hi - lo) * k // 4 : lo + (hi - lo) * (k + 1) // 4].sum(1) for k in range(4)]
                ps[S] = ((q[0] + q[1]) + q[2]) + q[3]
            col = torch.zeros((B, 128))
            for S in sorted(ps):
                col = col + ps[S]
            us.append(u)
            parts.append((ps, col))
        gsum = torch.zeros((B, 128))
        for _, col in parts:
            gsum = gsum + col
        for r, (t0, t1) in enumerate(ranges):
            rows = []
            for t in [*range(t0 - d, t0), *range(t1, t1 + d)]:
                rows.append(us[t // tc][:, t - (t // tc) * tc] if 0 <= t < T else torch.zeros((B, 128)))
            u_ext = torch.cat([torch.stack(rows[:d], 1), us[r], torch.stack(rows[d:], 1)], dim=1)
            n = t1 - t0
            loc = sum(u_ext[:, k * d : k * d + n] @ bp["K"][i, k] for k in range(3))
            m = []
            for S in range(t0 // seg_len, (t1 - 1) // seg_len + 1):
                tot = torch.zeros((B, 128))
                for ps, _ in parts:
                    if S in ps:
                        tot = tot + ps[S]
                ctx = gsum / T + tot / min(seg_len, T - S * seg_len)
                a = torch.relu(ctx @ bp["Wc1"][i] + bp["bc1"][i])
                m.append(torch.sigmoid(a @ bp["Wc2"][i] + bp["bc2"][i]))
            seg = torch.arange(t0, t1) // seg_len - t0 // seg_len
            buf[:, t0:t1, c_in : c_in + 32] = loc * torch.stack(m, 1)[:, seg]
    return buf


class TestClusterSplit:
    """K2's bf16 kernel splits T over the CTAs of a cluster; its decomposition
    (emulated in fp32) is the block's function, and its launch plan covers
    every frame once, fits shared memory and fills the card."""

    @pytest.mark.parametrize("cl", [1, 2, 3, 4])
    @pytest.mark.parametrize("T", [57, 199, 200, 250])
    def test_split_matches_the_twin(self, T, cl):
        d = 2 if T % 2 else 1
        _, _, bp = _jax_block_params(64, 3, d, seed=T + cl)
        bp = _to_torch(bp)
        x = torch.from_numpy(np.random.default_rng(T * cl).standard_normal((2, T, 64)).astype(np.float32))
        got = _split_block(x, bp, d, cl)
        ref = K2.cam_dense_block_infer(x, bp, d, dtype=torch.float32)
        torch.testing.assert_close(got, ref, rtol=0, atol=2e-5)

    def test_some_cta_edge_falls_inside_a_segment(self):
        edges = {(T, cl): [r * -(-T // cl) for r in range(1, cl)] for T in (57, 199, 200, 250) for cl in (2, 3, 4)}
        assert any(e % 100 for es in edges.values() for e in es)
        assert 67 in edges[(199, 3)] and 125 in edges[(250, 2)]

    def test_plan_fills_the_card_at_the_main_shape(self):
        for c_max, d in ((512, 1), (1024, 2), (1024, 2)):
            plan = K2.launch_plan(64, 199, d, c_max)
            assert 64 * plan.cl >= 128 and 64 * plan.cl <= K2.N_SM
            assert not plan.u_global

    @pytest.mark.parametrize("B", [1, 3, 16, 64, 67, 136, 512])
    def test_plan_covers_every_frame_once_and_fits(self, B):
        from speaker_diarization_tpu_torch.kernels._build import SMEM_LIMIT

        # T up to the 8 s window's 400 frames, and long windows beyond it
        for T in (1, 16, 57, 199, 200, 250, 399, 400, 700, 3000):
            for c_max, d in ((512, 1), (1024, 2), (144, 2)):
                plan = K2.launch_plan(B, T, d, c_max)
                frames = [t for t0, t1 in plan.ranges(T) for t in range(t0, t1)]
                assert frames == list(range(T)), (B, T, plan)
                assert 1 <= plan.cl <= 8 and plan.smem <= SMEM_LIMIT, (B, T, plan)
                assert plan.smem == K2.smem_bytes_bf16(c_max, plan.u_rows, plan.nls)
                if T <= 400:
                    assert B * plan.cl <= max(B, K2.N_SM), (B, T, plan)


def _apply(jmodel, variables, fb, mode):
    return jax.jit(jmodel.apply, static_argnums=(2, 3))(variables, jnp.asarray(fb), False, mode)


@pytest.fixture(scope="module")
def camp_pair():
    """The JAX CAM++ (small depth, perturbed stats) and the port loaded from it."""
    jmodel = JCAMPPlus(block_layers=(2, 3), block_dilations=(1, 2))
    fb0 = jnp.zeros((1, 200, 80), jnp.float32)
    v = _perturb_stats(jax.jit(jmodel.init, static_argnums=(2, 3))(jax.random.PRNGKey(0), fb0, False, "embedding"), 3)
    model = CAMPPlus(block_layers=(2, 3), block_dilations=(1, 2)).eval()
    model.load_state_dict(campplus_from_flax(v["params"], v["batch_stats"]))
    return jmodel, v, model


class TestCAMPPlus:
    @pytest.mark.parametrize("T100", [200, 398])
    def test_frames_fused_and_module_paths(self, camp_pair, T100):
        jmodel, v, model = camp_pair
        fb = np.random.default_rng(T100).standard_normal((2, T100, 80)).astype(np.float32)
        ref = np.asarray(_apply(jmodel, v, fb, "frames"))
        ref_fused = np.asarray(jax.jit(lambda v, x: JFused.campplus_frames_fused(jmodel, v, x))(v, jnp.asarray(fb)))
        with torch.no_grad():
            mod = model(torch.from_numpy(fb), mode="frames").numpy()
            fused = TFused.campplus_frames_fused(model, torch.from_numpy(fb)).numpy()
        assert mod.shape == ref.shape and ref.shape[1] == -(-T100 // 2)
        np.testing.assert_allclose(mod, ref, atol=2e-4, rtol=2e-3)
        np.testing.assert_allclose(fused, ref_fused, atol=2e-4, rtol=2e-3)
        np.testing.assert_allclose(fused, ref, atol=2e-4, rtol=2e-3)

    def test_embedding(self, camp_pair):
        jmodel, v, model = camp_pair
        fb = np.random.default_rng(9).standard_normal((2, 300, 80)).astype(np.float32)
        ref = np.asarray(_apply(jmodel, v, fb, "embedding"))
        with torch.no_grad():
            got = model(torch.from_numpy(fb), mode="embedding").numpy()
        np.testing.assert_allclose(got, ref, atol=2e-4, rtol=2e-3)

    def test_bf16_fused_close(self, camp_pair):
        jmodel, v, model = camp_pair
        fb = np.random.default_rng(4).standard_normal((2, 200, 80)).astype(np.float32)
        ref = np.asarray(_apply(jmodel, v, fb, "frames"))
        with torch.no_grad():
            got = TFused.campplus_frames_fused(model, torch.from_numpy(fb).to(torch.bfloat16)).float().numpy()
        assert np.mean(np.abs(got - ref)) < 5e-2, np.mean(np.abs(got - ref))

    def test_port_weights_load_into_jax(self):
        """Port state dict → the JAX package's own converter → same frames."""
        model = CAMPPlus(block_layers=(2, 2), block_dilations=(1, 2)).eval()
        init_weights_(model, torch.Generator().manual_seed(11))
        params, stats = campplus_torch_to_flax(model.state_dict())
        jmodel = JCAMPPlus(block_layers=(2, 2), block_dilations=(1, 2))
        fb = np.random.default_rng(11).standard_normal((2, 160, 80)).astype(np.float32)
        ref = np.asarray(_apply(jmodel, {"params": params, "batch_stats": stats}, fb, "frames"))
        with torch.no_grad():
            got = model(torch.from_numpy(fb), mode="frames").numpy()
        np.testing.assert_allclose(got, ref, atol=2e-4, rtol=2e-3)
        # and the converter round trip is exact
        back = campplus_from_flax(params, stats)
        sd = model.state_dict()
        assert set(back) == set(sd)
        for k in sd:
            torch.testing.assert_close(back[k], sd[k], rtol=0, atol=0)
