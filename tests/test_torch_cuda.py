"""The port's CUDA kernels on the card, against their plain versions: the
receive kernel on the f32 wire, in every decode mode and with each defense
screen, its two routes (the launch counts by route, and the grouped kernel
bitwise equal to the strided one at d <= 32), the send kernels of the
quantized codecs (bitwise) and their two routes (the launch counts by
route, and the tiled kernels bitwise equal to the strided ones at d <= 57,
the error-feedback codecs included), the voted-predict kernel on both its
routes (bitwise, launch counts by route), the population Pegasos and merge
kernels and each one's two layouts (launch counts by layout), the
flash-attention kernel on both its routes (tensor cores for
TMA-readable bf16 at head_dim 64/128/256, CUDA cores for the rest), and the
sharded engine against the reference engine on the f32 and the quantized
wires and under Byzantine faults, with and without a serving hook, and
armed with telemetry (its streams equal to the reference engine's); the
compact packings bit for bit the dense run (kernel #1 on the gathered
receivers, #2-#4 on the senders' rows, kernel #2 with ``rows`` against
its plain version) and Adaline and logistic regression on the vector
apply against the reference engine; the reduced LM (and the reduced moe,
ssm and hybrid configs) served on the card against the same weights
served on the CPU; and the paper's baselines,
WB1/WB2 bagging and the sequential Pegasos chain, on kernel #6 against the
same runs on the CPU; the kernel wrappers refusing inputs that require
grad, the one-shot ``_ef`` send counted as kernel #4, the gossip exchange
on kernels #2 and #4 bit for bit its plain encode's, and the reduced
trainer on the card.

These tests need a CUDA device (the kernels have no CPU mode) and skip
without one. They import neither JAX nor the JAX package, so they run on a
machine with only PyTorch: ``python -m pytest -q -m cuda
tests/test_torch_cuda.py``. The inputs and comparisons are
``chip_smoke.py``'s own, at other shapes and seeds."""
import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import random
from repro_torch.configs.gossip_linear import (GossipLinearConfig,
                                               with_failure_scenario)
from repro_torch.data.synthetic import make_linear_dataset
from repro_torch.kernels import gossip_cycle as gc

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(smoke)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n,d,c,k", [(4099, 57, 10, 4), (257, 16, 3, 5),
                                     (64, 9947, 10, 4)])
@pytest.mark.parametrize("variant", ["rw", "mu", "um"])
def test_receive_kernel_matches_plain_version(cuda, variant, n, d, c, k):
    """Integer state equal; float state within rtol 1e-5 and atol 1e-5
    (1e-4 at d = 9947: the margin is summed in another order)."""
    base = smoke.receive_inputs(n + d, n, d, c, k, cuda)
    before = gc.fused_receive_apply.launches
    smoke.compare_kernel(base, variant, 1e-3, 1e-4 if d > 1000 else 1e-5)
    assert gc.fused_receive_apply.launches == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("d,k", [(1, 4), (7, 5), (10, 4), (16, 8), (32, 1),
                                 (33, 4), (10, 9), (57, 4)])
def test_receive_route_launch_counts_follow_the_rule(cuda, d, k):
    """``receive_route(d, K)``'s kernel takes the launch: its count and the
    total up by one, the other route's unchanged."""
    base = smoke.receive_inputs(d + k, 515, d, 3, k, cuda)
    want = gc.receive_route(d, k)
    assert want == ("grouped" if d <= 32 and k <= 8 else "strided")
    total = gc.fused_receive_apply.launches
    routes = dict(gc.fused_receive_apply.route_launches)
    _, _, took = smoke.run_route(base, "mu", 1e-3)
    assert took == [want]
    assert gc.fused_receive_apply.launches == total + 1
    assert gc.fused_receive_apply.route_launches == dict(
        routes, **{want: routes[want] + 1})


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["f32", "affine8", "int4", "ternary"])
@pytest.mark.parametrize("defense", ["none", *smoke.DEFENSE_MODES])
@pytest.mark.parametrize("d", [1, 7, 10, 16, 32])
def test_grouped_route_equals_strided_route_bitwise(cuda, d, defense, mode):
    """The grouped kernel against the strided one forced on the same
    inputs (ragged N, K > C, rows crafted for every verdict under a
    screen), rw/mu/um: state, cache_t and the counts equal bit for bit;
    and, both routes summing the screen in sequence as the plain version
    does, the gated and clipped counts equal to the plain version's."""
    wire = None if mode == "f32" else smoke.DECODE_WIRES[mode]
    base = smoke.receive_inputs(3 * d + len(defense), 2003, d, 3, 5, cuda,
                                wire=wire, crafted=defense != "none")
    for variant in ("rw", "mu", "um"):
        assert smoke.compare_routes(base, variant, 1e-3, wire,
                                    defense) == "grouped"
        smoke.compare_kernel(base, variant, 1e-3, 1e-5, wire=wire,
                             defense=defense)


@pytest.mark.cuda
def test_nine_rounds_take_the_strided_route(cuda):
    """K = 9 is past the grouped kernel's rounds: the strided kernel takes
    it, and a forced grouped launch is refused before it starts."""
    base = smoke.receive_inputs(9, 1031, 10, 3, 9, cuda)
    strided = gc.fused_receive_apply.route_launches["strided"]
    smoke.compare_kernel(base, "um", 1e-3, 1e-5)
    assert gc.fused_receive_apply.route_launches["strided"] == strided + 1
    with pytest.raises(ValueError):
        smoke.run_route(base, "um", 1e-3, route="grouped")


@pytest.mark.cuda
@pytest.mark.parametrize("mode", sorted(smoke.DECODE_WIRES))
@pytest.mark.parametrize("variant", ["rw", "mu", "um"])
def test_receive_kernel_decodes_like_plain_version(cuda, variant, mode):
    """Each decode mode at d = 57 with K > C: integer state equal, float
    state within rtol 1e-5 and atol 1e-5."""
    base = smoke.receive_inputs(11, 2003, 57, 3, 5, cuda,
                                wire=smoke.DECODE_WIRES[mode])
    before = gc.fused_receive_apply.launches
    smoke.compare_kernel(base, variant, 1e-3, 1e-5,
                         wire=smoke.DECODE_WIRES[mode])
    assert gc.fused_receive_apply.launches == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1, 7, 10, 57, 9947])
@pytest.mark.parametrize("name", smoke.SEND_CODECS)
def test_send_kernel_matches_plain_version_bitwise(cuda, name, d):
    n = 1031 if d < 1000 else 129
    w, ef = smoke.send_inputs(d, n, d, cuda)
    kernel = gc.send_kernel_name(name)
    before = gc.quantize_send.launches[kernel]
    _, route = smoke.compare_send(name, w, ef, random.key(d, device=cuda))
    # the tiled route is also held to the strided one forced on the inputs
    assert gc.quantize_send.launches[kernel] == before + (
        2 if route == "tiled" else 1)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1, 7, 10, 16, 32, 57])
@pytest.mark.parametrize("name", smoke.TILED_CODECS)
def test_tiled_send_route_equals_strided_route_bitwise(cuda, name, d):
    """The tiled send kernel against the strided one forced on the same
    models (ragged last tile, mixed-sign zero, all -0.0 and NaN rows) and
    against the plain version: every output equal bit for bit."""
    w, ef = smoke.send_inputs(7 * d, 1031, d, cuda)
    key = random.key(d, device=cuda)
    _, route = smoke.compare_send(name, w, ef, key)
    assert route == "tiled"
    k = key if name == "int8_sr" else None
    smoke.same_outputs(name, ("codes", "scale", "zp"),
                       smoke.run_send(w, name, k, route="tiled"),
                       smoke.run_send(w, name, k, route="strided"),
                       "strided route")


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1, 7, 10, 16, 32, 57])
@pytest.mark.parametrize("name", smoke.EF_CODECS)
def test_tiled_ef_send_route_equals_strided_route_bitwise(cuda, name, d):
    """Under error feedback: the tiled send kernel against the strided one
    forced on the same models and residuals (ragged last tile, the edge
    rows) and against the plain version: packed bytes, scales and
    residuals equal bit for bit."""
    w, ef = smoke.send_inputs(11 * d, 1031, d, cuda)
    _, route = smoke.compare_send(name, w, ef, None)
    assert route == "tiled"
    smoke.same_outputs(name, ("payload", "scale", "resid"),
                       smoke.run_send(w, name, None, ef, route="tiled"),
                       smoke.run_send(w, name, None, ef, route="strided"),
                       "strided route")


@pytest.mark.cuda
@pytest.mark.parametrize("name", smoke.EF_CODECS)
def test_ef_send_route_counts_the_residual_alignment(cuda, name):
    """An aligned model with a residual view at an unaligned offset takes
    the strided route (bitwise equal to the plain version); the aligned
    pair takes the tiled one."""
    w, ef = smoke.send_inputs(3, 515, 10, cuda)
    odd = torch.empty(515 * 10 + 1, device=cuda)[1:].view(515, 10)
    odd.copy_(ef)
    routes = dict(gc.quantize_send.route_launches)
    assert smoke.compare_send(name, w, odd, None)[1] == "strided"
    assert gc.quantize_send.route_launches == dict(
        routes, strided=routes["strided"] + 1)
    routes = dict(gc.quantize_send.route_launches)
    assert smoke.compare_send(name, w, ef, None)[1] == "tiled"
    assert gc.quantize_send.route_launches == dict(
        routes, tiled=routes["tiled"] + 1, strided=routes["strided"] + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [10, 32, 57, 58])
@pytest.mark.parametrize("name", smoke.MAIN_WIRES)
def test_send_route_launch_counts_follow_the_rule(cuda, name, d):
    """``send_route(d, name)``'s kernel takes the launch: its count and the
    kernel's up by one, the other route's unchanged; a model view at an
    unaligned offset goes to the strided route."""
    w, ef = smoke.send_inputs(d, 515, d, cuda)
    key = random.key(d, device=cuda)
    want = gc.send_route(d, name)
    assert want == ("tiled" if d <= 57 else "strided")
    kernel = gc.send_kernel_name(name)
    launches = dict(gc.quantize_send.launches)
    routes = dict(gc.quantize_send.route_launches)
    gc.quantize_send(w, name, key=key if name == "int8_sr" else None,
                     ef=ef if name == "int4_ef" else None)
    assert gc.quantize_send.launches == dict(
        launches, **{kernel: launches[kernel] + 1})
    assert gc.quantize_send.route_launches == dict(
        routes, **{want: routes[want] + 1})
    assert smoke.compare_send(name, w, ef, key)[1] == want
    odd = torch.empty(515 * d + 1, device=cuda)[1:].view(515, d)
    odd.copy_(w)
    assert gc.send_route(d, name, odd.data_ptr() % 16 == 0) == "strided"
    before = gc.quantize_send.route_launches["strided"]
    smoke.compare_send(name, odd, ef, key)
    assert gc.quantize_send.route_launches["strided"] == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("wire", [None, *smoke.MAIN_WIRES])
def test_sharded_engine_with_kernel_matches_reference_engine(cuda, wire):
    n = 2000
    X, y = make_linear_dataset(np.random.default_rng(0), n + 500, 10,
                               noise=0.07, separation=2.5)
    cfg = with_failure_scenario(GossipLinearConfig(
        name="cuda-test", dim=10, n_nodes=n, n_test=500, class_ratio=(1, 1),
        lam=1e-3, variant="mu"), "extreme")
    smoke.compare_engines(dataclasses.replace(cfg, wire_dtype=wire), X, y,
                          n, cuda, cycles=12, eval_every=6, seed=1)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["f32", *smoke.SCREEN_WIRES])
@pytest.mark.parametrize("defense", smoke.DEFENSE_MODES)
def test_receive_kernel_screens_like_plain_version(cuda, defense, mode):
    """Each defense screen after each decode family at d = 57 with K > C,
    on rows crafted for every verdict: integer state and the gated and
    clipped counts equal, float state within rtol 1e-5 and atol 1e-5."""
    wire = smoke.SCREEN_WIRES.get(mode)
    base = smoke.receive_inputs(13, 2003, 57, 3, 5, cuda, wire=wire,
                                crafted=True)
    for variant in ("rw", "mu", "um"):
        before = gc.fused_receive_apply.launches
        _, (gated, clipped) = smoke.compare_kernel(
            base, variant, 1e-3, 1e-5, wire=wire, defense=defense)
        assert gc.fused_receive_apply.launches == before + 1
        assert gated > 0 and (clipped > 0) == (defense == "norm_clip")


@pytest.mark.cuda
@pytest.mark.parametrize("m,c,d", smoke.VOTED_SHAPES)
def test_voted_predict_kernel_matches_plain_version_bitwise(cuda, m, c, d):
    """Both routes (grouped at d <= 32, strided), snapshot and gathered
    forms, bit for bit; each launch counted on its route."""
    from repro_torch.kernels import voted_predict as vp
    before = dict(vp.voted_predict_batched.route_launches)
    ans = smoke.compare_voted(*smoke.voted_inputs(m + 1, m, c, d, cuda))
    want = dict(before)
    for route in smoke.voted_routes(d, c):
        want[route] += 2
    assert smoke.voted_routes(d, c) == (
        ("grouped", "strided") if d <= 32 else ("strided",))
    assert vp.voted_predict_batched.route_launches == want
    assert ans[:4].tolist() == [1.0, 1.0, 1.0, -1.0]


@pytest.mark.cuda
@pytest.mark.parametrize("fault,wire,defense", smoke.FAULT_RUNS)
def test_sharded_engine_under_faults_matches_reference_engine(
        cuda, fault, wire, defense):
    """Economy and fault counters exact, curves within 0.02; a serving
    hook on the first configuration changes nothing, bit for bit."""
    n = 2000
    X, y = make_linear_dataset(np.random.default_rng(0), n + 500, 10,
                               noise=0.07, separation=2.5)
    cfg = with_failure_scenario(GossipLinearConfig(
        name="cuda-test", dim=10, n_nodes=n, n_test=500, class_ratio=(1, 1),
        lam=1e-3, variant="mu", wire_dtype=wire, fault_model=fault,
        byzantine_frac=0.1, defense=defense), "extreme")
    kw = dict(cycles=12, eval_every=6, seed=1)
    sh, _, ref = smoke.compare_engines(cfg, X, y, n, cuda, **kw)
    assert sh.fault_stats["corrupted"] > 0
    if (fault, wire, defense) == smoke.FAULT_RUNS[0]:
        for engine, unhooked in (("sharded", sh), ("reference", ref)):
            assert smoke.hooked_equals_unhooked(cfg, X, y, n, cuda, engine,
                                                unhooked, **kw) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("faulty", [False, True])
def test_armed_sharded_engine_streams_equal_reference_engine(cuda, faulty):
    """An armed run of the sharded engine on the card (N = 20 000, the
    extreme scenario; with ``faulty``, int4_ef under 10 % sign_flip and
    norm_clip): bit for bit the unarmed run, its streams adding up to the
    totals, and every integer stream equal to the armed reference
    engine's on the card."""
    from repro_torch.core.simulation import run_simulation
    from repro_torch.core.telemetry import METRIC_STREAMS, Telemetry
    n, kw = 20_000, dict(cycles=12, eval_every=6, seed=1, device=cuda)
    X, y = make_linear_dataset(np.random.default_rng(0), n + 500, 10,
                               noise=0.07, separation=2.5)
    extra = (dict(wire_dtype="int4_ef", fault_model="sign_flip",
                  byzantine_frac=0.1, defense="norm_clip") if faulty else {})
    cfg = with_failure_scenario(GossipLinearConfig(
        name="cuda-test", dim=10, n_nodes=n, n_test=500, class_ratio=(1, 1),
        lam=1e-3, variant="mu", **extra), "extreme")
    args = (cfg, X[:n], y[:n], X[n:], y[n:])
    plain = run_simulation(*args, engine="sharded", **kw)
    tels = {engine: Telemetry() for engine in ("sharded", "reference")}
    armed = run_simulation(*args, engine="sharded",
                           telemetry=tels["sharded"], **kw)
    run_simulation(*args, engine="reference", telemetry=tels["reference"],
                   **kw)
    smoke.check_armed(tels["sharded"], armed, plain, kw["cycles"], "card")
    for name, spec in METRIC_STREAMS.items():
        if spec.dtype == "int":
            assert np.array_equal(tels["sharded"].stream_array(name),
                                  tels["reference"].stream_array(name)), name
    if faulty:
        assert tels["sharded"].stream_array("clipped").sum() > 0
        assert (tels["sharded"].stream_array("ef_residual_rms") > 0).all()
    assert {s.name for s in tels["sharded"].spans} >= {
        "setup", "draw_enqueue", "draw_readback", "route_chunk",
        "dense_table", "table_upload", "chunk_dispatch", "eval",
        "collect_results"}


@pytest.mark.cuda
@pytest.mark.parametrize("n,d", [(4099, 10), (1031, 57), (33, 9947)])
@pytest.mark.parametrize("name", sorted(smoke.ROW_KERNELS))
def test_row_kernels_match_plain_versions(cuda, name, n, d):
    """Kernels #6 and #7 through ``kernels/ops.py``: t equal, w within rtol
    2e-5 and atol 1e-5."""
    from repro_torch.kernels import gossip_merge as gm
    from repro_torch.kernels import pegasos_update as pu
    fn = {"pegasos_update": pu.pegasos_update,
          "merge_update": gm.merge_update}[name]
    inputs = smoke.row_inputs(n + d, n, d, cuda, merge=name == "merge_update")
    before = fn.launches
    smoke.compare_rows(name, inputs, 1e-3)
    assert fn.launches == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("n,d", [(1, 1), (4099, 7), (4099, 10), (1031, 32),
                                 (1031, 57), (515, 128)])
def test_merge_layouts_match_each_other_and_plain_version(cuda, n, d):
    """#7's tiled and strided layouts forced on the same inputs: t equal,
    w within rtol 2e-5 and atol 1e-5 of the plain version's; each forced
    launch counted on its layout."""
    from repro_torch.kernels import gossip_merge as gm
    from repro_torch.kernels import ref
    inputs = smoke.row_inputs(n + d, n, d, cuda, merge=True)
    pw, pt = ref.merge_update_ref(*inputs, 1e-3)
    for route in ("tiled", "strided"):
        before = dict(gm.merge_update.route_launches)
        w, t = gm._launch_merge(inputs, n, d, 1e-3, route=route)
        torch.cuda.synchronize()
        assert gm.merge_update.route_launches == dict(
            before, **{route: before[route] + 1})
        assert torch.equal(t, pt)
        torch.testing.assert_close(w, pw, rtol=2e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("n,d", [(1, 1), (4099, 7), (4099, 10), (1031, 32),
                                 (1031, 57), (515, 128)])
def test_step_layouts_match_each_other_and_plain_version(cuda, n, d):
    """#6's tiled and strided layouts forced on the same inputs: t equal,
    w within rtol 2e-5 and atol 1e-5 of the plain version's; each forced
    launch counted on its layout."""
    from repro_torch.kernels import pegasos_update as pu
    from repro_torch.kernels import ref
    inputs = smoke.row_inputs(n + d, n, d, cuda)
    pw, pt = ref.pegasos_update_ref(*inputs, 1e-3)
    for route in ("tiled", "strided"):
        before = dict(pu.pegasos_update.route_launches)
        w, t = pu._launch_step(inputs, n, d, 1e-3, route=route)
        torch.cuda.synchronize()
        assert pu.pegasos_update.route_launches == dict(
            before, **{route: before[route] + 1})
        assert torch.equal(t, pt)
        torch.testing.assert_close(w, pw, rtol=2e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [10, 57, 58, 9947])
def test_row_route_launch_counts_follow_the_rule(cuda, d):
    """Through ``kernels/ops.py``: the merge on ``row_route(d, True)``'s
    layout and the step on ``row_route(d, False)``'s (an operand at an
    unaligned offset on the strided one)."""
    from repro_torch.kernels import gossip_merge as gm
    from repro_torch.kernels import ops
    from repro_torch.kernels import pegasos_update as pu
    n = 515 if d < 1000 else 33
    w1, t1, w2, t2, x, y = smoke.row_inputs(d, n, d, cuda, merge=True)
    want = pu.row_route(d, True)
    want_step = pu.row_route(d, False)
    assert want == ("tiled" if d <= 57 else "strided")
    assert want_step == ("tiled" if d <= 57 else "strided")
    merge, step = (dict(gm.merge_update.route_launches),
                   dict(pu.pegasos_update.route_launches))
    ops.merge_update(w1, t1, w2, t2, x, y, lam=1e-3)
    ops.pegasos_update(w1, t1, x, y, lam=1e-3)
    assert gm.merge_update.route_launches == dict(
        merge, **{want: merge[want] + 1})
    assert pu.pegasos_update.route_launches == dict(
        step, **{want_step: step[want_step] + 1})
    odd = torch.empty(n * d + 1, device=cuda)[1:].view(n, d)
    odd.copy_(x)
    merge, step = (dict(gm.merge_update.route_launches),
                   dict(pu.pegasos_update.route_launches))
    smoke.compare_rows("merge_update", (w1, t1, w2, t2, odd, y), 1e-3)
    smoke.compare_rows("pegasos_update", (w1, t1, odd, y), 1e-3)
    assert gm.merge_update.route_launches == dict(
        merge, strided=merge["strided"] + 1)
    assert pu.pegasos_update.route_launches == dict(
        step, strided=step["strided"] + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("s,h,kv,causal,window", [
    (1, 16, 8, True, None), (37, 4, 2, True, None), (130, 8, 1, False, 64),
    (200, 2, 2, True, 16), (257, 16, 8, False, None)])
@pytest.mark.parametrize("hd", smoke.FLASH_HEAD_DIMS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_kernel_matches_plain_version(cuda, dtype, hd, s, h, kv, causal,
                                            window):
    """Kernel #8: float32 within 2e-4, bfloat16 within atol 3e-2; one case
    of each on strided inputs."""
    from repro_torch.kernels import flash_attention as fa
    dt = getattr(torch, dtype)
    for strided in (False, True):
        q, k, v = smoke.flash_inputs(s + hd, 2, s, h, kv, hd, dt, cuda,
                                     strided=strided)
        before = fa.flash_attention.launches
        smoke.compare_flash(q, k, v, causal, window)
        assert fa.flash_attention.launches == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("s", [1, 37, 300, 2048])
@pytest.mark.parametrize("group", [1, 2, 8])
@pytest.mark.parametrize("hd", [64, 128])
def test_flash_tensor_core_route_matches_plain_version(cuda, hd, group, s):
    """bf16 at head_dim 64/128, H/KV 1, 2, 8, causal or not, window None
    or 64, contiguous and as (B, heads, S, hd) views: each call on the
    tensor-core route (its count and the total up by one, the CUDA-core
    count unchanged), within ``compare_flash``'s bf16 tolerance."""
    from repro_torch.kernels import flash_attention as fa
    kv = 2
    b = 2 if s < 2048 else 1
    for strided in (False, True):
        q, k, v = smoke.flash_inputs(s + hd + group, b, s, kv * group, kv,
                                     hd, torch.bfloat16, cuda,
                                     strided=strided)
        for causal in (True, False):
            for window in (None, 64):
                total = fa.flash_attention.launches
                routes = dict(fa.flash_attention.route_launches)
                smoke.compare_flash(q, k, v, causal, window, "tensor_core")
                assert fa.flash_attention.launches == total + 1
                assert fa.flash_attention.route_launches == dict(
                    routes, tensor_core=routes["tensor_core"] + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("s", [300, 2048])
@pytest.mark.parametrize("window", [None, 64])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_hd256_mqa_matches_plain_version(cuda, dtype, window, s):
    """head_dim 256 over one kv head (recurrentgemma's local attention),
    causal: bfloat16 on the tensor-core route (64-key tiles), float32 on
    the CUDA-core route, each call's route count up by one, within
    ``compare_flash``'s tolerance."""
    from repro_torch.kernels import flash_attention as fa
    dt = getattr(torch, dtype)
    want = "tensor_core" if dt == torch.bfloat16 else "cuda_core"
    q, k, v = smoke.flash_inputs(s + 256, 2 if s < 2048 else 1, s, 16, 1,
                                 256, dt, cuda)
    routes = dict(fa.flash_attention.route_launches)
    smoke.compare_flash(q, k, v, True, window, want)
    assert fa.flash_attention.route_launches == dict(
        routes, **{want: routes[want] + 1})


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["strided", "unaligned"])
def test_flash_hd256_views_tma_cannot_read_take_cuda_cores(cuda, layout):
    """bf16 at head_dim 256 that TMA can read, as (B, heads, S, hd) views,
    takes the tensor cores; unaligned views stay on the CUDA cores."""
    from repro_torch.kernels import flash_attention as fa
    want = "tensor_core" if layout == "strided" else "cuda_core"
    q, k, v = smoke.flash_inputs(7, 1, 300, 16, 1, 256, torch.bfloat16,
                                 cuda, **{layout: True})
    routes = dict(fa.flash_attention.route_launches)
    smoke.compare_flash(q, k, v, True, 64, want)
    assert fa.flash_attention.route_launches == dict(
        routes, **{want: routes[want] + 1})


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["mixtral-8x22b", "llama4-scout-17b-a16e",
                                  "mamba2-780m", "recurrentgemma-9b"])
def test_reduced_family_served_on_card_matches_cpu(cuda, arch):
    diff, toks = smoke.small_server_check(cuda, seed=4, arch=arch)
    assert toks.shape == (2, 16)


def odd_row_stride(a):
    """The same values with rows of heads * hd + 4 elements."""
    b, s, h, hd = a.shape
    buf = torch.zeros(b, s, h * hd + 4, dtype=a.dtype, device=a.device)
    buf[..., :h * hd] = a.flatten(2)
    return buf[..., :h * hd].unflatten(2, (h, hd))


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["unaligned", "odd_row_stride"])
def test_flash_views_tma_cannot_read_take_cuda_core_route(cuda, layout):
    """bf16 at head_dim 128, but a base one element past a 16-byte
    boundary or an S stride no multiple of 8: the CUDA-core kernel, within
    the same tolerance."""
    from repro_torch.kernels import flash_attention as fa
    q, k, v = smoke.flash_inputs(3, 2, 300, 16, 8, 128, torch.bfloat16,
                                 cuda, unaligned=layout == "unaligned")
    if layout == "odd_row_stride":
        q, k, v = map(odd_row_stride, (q, k, v))
        assert q.stride(1) % 8 and q.data_ptr() % 16 == 0
    routes = dict(fa.flash_attention.route_launches)
    smoke.compare_flash(q, k, v, True, None, "cuda_core")
    assert fa.flash_attention.route_launches == dict(
        routes, cuda_core=routes["cuda_core"] + 1)


@pytest.mark.cuda
def test_reduced_lm_served_on_card_matches_cpu(cuda):
    diff, toks = smoke.small_server_check(cuda, seed=3)
    assert toks.shape == (2, 16)


def packing_data(n=2000):
    X, y = make_linear_dataset(np.random.default_rng(0), n + 500, 10,
                               noise=0.07, separation=2.5)
    cfg = with_failure_scenario(GossipLinearConfig(
        name="cuda-test", dim=10, n_nodes=n, n_test=500, class_ratio=(1, 1),
        lam=1e-3, variant="mu"), "extreme")
    return cfg, X, y


@pytest.mark.cuda
@pytest.mark.parametrize("wire,fault,defense", smoke.PACKING_MIXES)
def test_every_packing_is_the_dense_run_on_the_card(cuda, wire, fault,
                                                    defense):
    """``compact``, ``compact_all`` and the chooser bit for bit the dense
    run (curves, economy, fault counters, EF norm, the cache at each eval
    point), kernel #1 on the grouped route once a cycle (twice under
    ``compact``) and #2-#4 once a cycle on the tiled route, the subset's
    rows included."""
    n = 2000
    cfg, X, y = packing_data(n)
    cfg = dataclasses.replace(cfg, wire_dtype=wire, fault_model=fault,
                              byzantine_frac=0.1 if fault else 0.0,
                              defense=defense)
    snaps = {m: [] for m in smoke.PACKINGS + (None,)}
    runs = {m: smoke.packing_run(cfg, X, y, n, 20, cuda, m, snaps=snaps[m])
            for m in smoke.PACKINGS + (None,)}
    for m, r in runs.items():
        assert smoke.run_outcome(r["res"]) == smoke.run_outcome(
            runs["dense"]["res"]), m
        smoke.same_snapshots(snaps[m], snaps["dense"], str(m))
    assert runs["compact"]["recv"] == 40
    assert runs["compact_all"]["recv"] == 20


@pytest.mark.cuda
def test_send_kernel_with_rows_matches_plain_version(cuda):
    """int8_sr with ``rows``: bitwise the plain version and the strided
    route, and at d = 10 the dense encode's rows."""
    assert smoke.check_send_rows(cuda) == len(smoke.SEND_ROWS_SHAPES)


@pytest.mark.cuda
@pytest.mark.parametrize("learner", smoke.VECTOR_LEARNERS)
def test_vector_learners_on_the_card_match_the_reference_engine(cuda,
                                                                learner):
    """Adaline and logistic regression (the vector apply, plain PyTorch on
    the card): economy equal to the reference engine's, curves within
    0.02, every packing bit for bit the dense run, no launch of the
    Pegasos receive kernel."""
    from repro_torch.core.simulation import run_simulation
    n = 2000
    cfg, X, y = packing_data(n)
    cfg = dataclasses.replace(cfg, learner=learner)
    args = (cfg, X[:n], y[:n], X[n:], y[n:])
    kw = dict(cycles=12, eval_every=6, seed=1, device=cuda)
    before = gc.fused_receive_apply.launches
    ref = run_simulation(*args, engine="reference", **kw)
    runs = [run_simulation(*args, engine="sharded", compact_mode=m, **kw)
            for m in smoke.PACKINGS + (None,)]
    assert gc.fused_receive_apply.launches == before
    for r in runs:
        assert smoke.run_outcome(r) == smoke.run_outcome(runs[0])
    sh = runs[-1]
    assert (sh.sent_total, sh.delivered_total, sh.lost_total,
            sh.overflow_total) == (ref.sent_total, ref.delivered_total,
                                   ref.lost_total, ref.overflow_total)
    assert max(abs(a - b) for a, b in zip(
        sh.err_fresh + sh.err_voted, ref.err_fresh + ref.err_voted)) <= 0.02


def small_problem(n, d, seed=0):
    rng = np.random.default_rng(seed)
    X, y = make_linear_dataset(rng, n + 200, d, noise=0.05, separation=3.0)
    return X[:n], y[:n], X[n:], y[n:]


@pytest.mark.cuda
@pytest.mark.parametrize("n,d,m", [(300, 10, 256), (500, 57, 2048),
                                   (200, 9947, 64)])
def test_bagging_on_the_card_matches_the_cpu(cuda, n, d, m):
    """``run_weighted_bagging`` with kernel #6 (``row_route``'s layout, once
    a cycle) against its plain version on the CPU: sample indices and t
    equal, W within ``chip_smoke.BAGGING_W_RTOL`` of max |W|, the curves
    within 0.02."""
    from repro_torch.kernels import pegasos_update as pu
    data = small_problem(n, d)
    pu.pegasos_update.launches = 0
    before = dict(pu.pegasos_update.route_launches)
    res, draws, last, _ = smoke.bagging_run(data, m, 20, 1e-4, cuda)
    assert pu.pegasos_update.launches == 20
    want = pu.row_route(d, False)
    assert pu.pegasos_update.route_launches[want] - before[want] == 20
    cres, cdraws, clast, _ = smoke.bagging_run(data, m, 20, 1e-4, "cpu")
    assert all(torch.equal(a, b) for a, b in zip(draws, cdraws))
    assert torch.equal(last[1], clast[1])
    assert float((last[0] - clast[0]).abs().max()) <= (
        smoke.BAGGING_W_RTOL * float(clast[0].abs().max()))
    assert res.cycles == cres.cycles
    assert max(abs(a - b) for a, b in zip(
        res.err_wb1 + res.err_wb2 + res.err_single,
        cres.err_wb1 + cres.err_wb2 + cres.err_single)) <= 0.02


@pytest.mark.cuda
@pytest.mark.parametrize("d", [10, 57, 9947])
def test_sequential_chain_on_the_card_matches_the_cpu(cuda, d):
    """``run_sequential_pegasos``: one launch of kernel #6 an iteration at
    N = 1, on ``row_route``'s layout (its views of padded rows are
    aligned); the final t equal to the CPU's, w within
    ``chip_smoke.BAGGING_W_RTOL`` of max |w|, the points within 0.02."""
    from repro_torch.core import ensemble
    from repro_torch.kernels import pegasos_update as pu
    X, y, Xt, yt = small_problem(300, d)
    pu.pegasos_update.launches = 0
    before = dict(pu.pegasos_update.route_launches)
    m, pts = ensemble.run_sequential_pegasos(X, y, Xt, yt, iters=250,
                                             lam=1e-4, eval_every=100,
                                             device=cuda)
    assert pu.pegasos_update.launches == 250
    want = pu.row_route(d, False)
    assert pu.pegasos_update.route_launches[want] - before[want] == 250
    cm, cpts = ensemble.run_sequential_pegasos(X, y, Xt, yt, iters=250,
                                               lam=1e-4, eval_every=100,
                                               device="cpu")
    assert int(m.t) == int(cm.t) == 250
    assert float((m.w.cpu() - cm.w).abs().max()) <= (
        smoke.BAGGING_W_RTOL * float(cm.w.abs().max()))
    assert [p[0] for p in pts] == [p[0] for p in cpts] == [100, 200, 250]
    assert max(abs(a[1] - b[1]) for a, b in zip(pts, cpts)) <= 0.02


def _wrapper_calls(dev):
    """Each CUDA kernel wrapper of the port with small inputs: (name, the
    float input that may require grad, a call taking that input)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import voted_predict as vp
    rec = smoke.receive_inputs(1, 257, 10, 4, 3, dev)
    w, t, x, y = smoke.row_inputs(2, 257, 10, dev)
    w1, t1, w2, t2, x2, y2 = smoke.row_inputs(3, 257, 10, dev, merge=True)
    vw, vc, vx, va = smoke.voted_inputs(4, 64, 10, 10, dev)
    q, k, v = smoke.flash_inputs(5, 1, 37, 2, 1, 64, torch.float32, dev)

    def receive(a):
        r = {key: val.clone() for key, val in rec.items()}
        r["msg_w"] = a
        return gc.fused_receive_apply(*(r[key] for key in smoke.ORDER),
                                      variant="mu", lam=1e-3)
    return [
        ("fused_receive_apply", rec["msg_w"], receive),
        ("quantize_send", w, lambda a: gc.quantize_send(a, "int4")),
        ("pegasos_update", w, lambda a: ops.pegasos_update(a, t, x, y,
                                                           lam=1e-3)),
        ("merge_update", w1, lambda a: ops.merge_update(a, t1, w2, t2, x2,
                                                        y2, lam=1e-3)),
        ("voted_predict_batched", vw,
         lambda a: vp.voted_predict_batched(a, vc, vx, va)),
        ("flash_attention", q, lambda a: ops.flash_attention(a, k, v)),
    ]


@pytest.mark.cuda
def test_kernel_wrappers_refuse_inputs_that_require_grad(cuda):
    """No kernel has a backward: an input that requires grad raises while
    grad mode is on, instead of a result whose gradient silently skips the
    kernel; the same call runs under ``torch.no_grad()``."""
    for name, a, call in _wrapper_calls(cuda):
        leaf = a.clone().requires_grad_(True)
        with pytest.raises(RuntimeError, match="no backward"):
            call(leaf)
        with torch.no_grad():
            call(leaf)
        call(a)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["int4_ef", "ternary_ef"])
def test_one_shot_ef_send_counts_as_the_packed_kernel(cuda, name):
    """An ``_ef`` codec sent without a residual (the gossip exchange's
    one-shot send) runs, and counts as, kernel #4; with one, #3."""
    w, ef = smoke.send_inputs(7, 515, 10, cuda)
    before = dict(gc.quantize_send.launches)
    one_shot = gc.quantize_send(w, name)
    assert gc.quantize_send.launches == dict(
        before, packed=before["packed"] + 1)
    plain = gc.quantize_send_plain(w, name)
    smoke.same_outputs(name, ("payload", "scale"), one_shot, plain, "plain")
    gc.quantize_send(w, name, ef=ef)
    assert gc.quantize_send.launches == dict(
        before, packed=before["packed"] + 1,
        packed_ef=before["packed_ef"] + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(smoke.EXCHANGE_KERNELS))
def test_gossip_merge_on_the_card_is_the_plain_encodes(cuda, name,
                                                       monkeypatch):
    """The exchange on send kernels #2 and #4 (one launch a leaf) is bit for
    bit the merge with the codec's plain encode on the card."""
    from repro_torch.core import gossip_optimizer as go
    from repro_torch.utils.tree import tree_leaves
    g = torch.Generator(device=cuda)
    g.manual_seed(3)
    params = {"emb": torch.randn((4, 300, 2048), generator=g, device=cuda)
              .to(torch.bfloat16),
              "w": [torch.randn((4, 64, 6144), generator=g, device=cuda),
                    torch.randn((4, 128), generator=g, device=cuda)],
              "s": torch.randn((4,), generator=g, device=cuda)}
    perm = (1, 0, 3, 2)
    before = dict(gc.quantize_send.launches)
    got = go.gossip_merge(params, perm, exchange_dtype=name)
    kernel = smoke.EXCHANGE_KERNELS[name]
    assert gc.quantize_send.launches == dict(
        before, **({kernel: before[kernel] + 4} if kernel else {}))
    monkeypatch.setattr(gc, "quantize_send", gc.quantize_send_plain)
    want = go.gossip_merge(params, perm, exchange_dtype=name)
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        assert torch.equal(a.view(torch.uint8), b.view(torch.uint8))


@pytest.mark.cuda
@pytest.mark.parametrize("dist", ["allreduce", "gossip"])
def test_reduced_training_runs_on_the_card(cuda, dist):
    from repro_torch.launch.train import train
    from repro_torch.utils.tree import tree_leaves
    params, hist = train(steps=4, batch=4, seq_len=32, d_model=64,
                         dist=dist, n_peers=2, log_every=1)
    assert len(hist) == 4 and all(np.isfinite(h[1]) for h in hist)
    assert all(p.device.type == "cuda" for p in tree_leaves(params))


@pytest.mark.cuda
@pytest.mark.parametrize("arch", [a for a, *_ in smoke.ENCDEC_RUNS])
def test_reduced_vlm_and_audio_served_on_card_match_cpu(cuda, arch):
    """Reduced whisper-medium and llama-3.2-vision-11b with every cross
    layer's gates set: the card's server against the CPU's, the prompt
    past whisper's 64 reduced positions."""
    diff, toks = smoke.small_server_check(cuda, seed=4, arch=arch,
                                          prepare=smoke.set_gates)
    assert toks.shape == (2, 16)
