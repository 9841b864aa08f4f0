"""The `recon_proj` driver at a tiny size with `imagenet_f4`'s structure
(conv-FCM decoder, the first FCM's groups the z channels, a projected
codebook, mid-block attention) on the CPU: the port agrees with the
conv-FCM reference within the cell's limits; the control and each planted
fault come out not correct. And the two readers this cell and
`cat-gen-int8` add, on synthetic records: the share they compute, None
where a counter or a kernel is missing, never 0."""

import copy

import pytest

from benchmark.harness import BENCH, Window, driver_module, load_json, \
    metric_reader
from benchmark.tests.test_portbench_drivers import SEED, _Patch, drive
from benchmark.tests.tiny import context, tiny_cell


def tiny_f4() -> dict:
    cfg = copy.deepcopy(load_json(BENCH / "configs" / "imagenet_f4.json"))
    m = cfg["model"]
    # ch_mult (1, 2, 4), no attn_resolutions, z 3 in 3 groups: as published
    m["codec"].update(base_channels=32, num_res_blocks=1, resolution=32)
    # a codebook wider than the latent, with near-ties that fp8 flips
    m["quantizer"].update(codebook_size=1024, codebook_dim=32)
    m["discriminator"].update(base_channels=8, num_layers=2)
    m["compute_dtype"] = "float32"
    cfg["loss"]["spectral_dtype"] = "float32"
    return cfg


def f4_cell():
    return tiny_cell("imagenet-f4-recon", tiny_f4(), "imagenet-f4-recon",
                     batch=2, keep_share=0.5, control_requests=2)


def test_port_agrees_with_the_reference(tmp_path):
    win, checks = drive(f4_cell(), tmp_path)
    assert win.work >= 1
    assert [c.name for c in checks] == ["code_gap_q999", "recon_err"]
    assert all(c.ok for c in checks), checks


def test_control_is_not_correct(tmp_path):
    cell = f4_cell()
    drv = driver_module(cell.traffic["driver"])
    got = drv.control(context(cell, SEED, tmp_path))["control"]
    limits = cell.traffic["limits"]
    assert any(got[k] > limits[k] for k in limits), got


def _altered_code(orig):
    def reconstruct(self, x, *a, **k):
        x_recon, idx = orig(self, x, *a, **k)
        idx = idx.clone()
        idx.view(-1)[0] = (idx.view(-1)[0] + 1) % self.cfg.quantizer \
            .codebook_size
        return x_recon, idx
    return reconstruct


def _taps_not_added(orig):
    def apply_fcm(self, h, i, taps):
        t = getattr(self, f"fcm_{i}")(h)
        taps.append(t)
        return t
    return apply_fcm


def faults():
    from favae_tpu_torch.models.codec import Decoder
    from favae_tpu_torch.models.vqgan import VQGANFCM
    return {
        "answer_altered": _Patch(VQGANFCM, "reconstruct", _altered_code),
        "taps_not_added": _Patch(Decoder, "_apply_fcm", _taps_not_added),
    }


@pytest.mark.parametrize("fault", ["answer_altered", "taps_not_added"])
def test_fault_is_not_correct(fault, tmp_path):
    _, checks = drive(f4_cell(), tmp_path, during_run=faults()[fault])
    assert not all(c.ok for c in checks), checks


def _record(counters, kernels):
    """A traced run's record: three requests, the port's counters as
    given (None: a program that keeps none), the trace's kernels as
    {name: (seconds, calls)} (None: no trace)."""
    win = Window(0.0, 10.0, 3, {}, extra={"work_span": "request"})
    trace = None if kernels is None else {
        "kernel_s": {k: s for k, (s, _) in kernels.items()},
        "kernel_calls": {k: n for k, (_, n) in kernels.items()}}
    return {"window": win, "trace": trace, "counters": counters,
            "spans": [("request", 1.0 + i, 1.5 + i) for i in range(3)]}


@pytest.fixture
def read(monkeypatch):
    from benchmark import port_counters

    def reading(name, record):
        monkeypatch.setattr(port_counters, "snapshot",
                            lambda: record["counters"])
        return metric_reader(name)(record)
    return reading


N, KD = 32 * 64 * 64, 8192 * 256
VQ = "vq_argmax(float const*, float const*, float const*, float*, int*)"
STEP = "decode_step_kernel(DecodeParams)"


def test_vq_roofline_reads_a_call_against_the_bf16_peak(read):
    # 4 calls of 2 N K D = 0.556 ms of bf16 peak, 6.2 ms each on the card
    rec = _record({"vq.macs": 4 * N * KD, "launches.vq_nearest": 4},
                  {VQ: (4 * 6.2e-3, 4), "other_kernel": (1.0, 9)})
    want = 100.0 * (2 * N * KD / 989e12) / 6.2e-3
    assert read("vq_roofline.f4", rec) == pytest.approx(want)
    assert 8.9 < want < 9.0


def test_decode_step_roofline_reads_a_launch_against_the_hbm_rate(read):
    # 256 launches of 620 MB, 2.1 ms each: 0.185 ms of bytes
    rec = _record({"decode_step.bytes": 256 * 620e6,
                   "launches.decode_step": 256},
                  {STEP: (10 * 2.1e-3, 10), VQ: (1.0, 1)})
    want = 100.0 * (620e6 / 3.35e12) / 2.1e-3
    assert read("decode_step_roofline.int8", rec) == pytest.approx(want)


@pytest.mark.parametrize("case", ["no_counters", "counter_missing",
                                  "no_launch", "kernel_missing",
                                  "no_trace", "no_device_time"])
@pytest.mark.parametrize("metric,counter,launches,kernel", [
    ("vq_roofline.f4", "vq.macs", "launches.vq_nearest", VQ),
    ("decode_step_roofline.int8", "decode_step.bytes",
     "launches.decode_step", STEP)])
def test_roofline_readers_give_none_where_nothing_is_read(
        read, case, metric, counter, launches, kernel):
    counters = {counter: 1e9, launches: 4}
    kernels = {kernel: (1e-3, 4), "elementwise_kernel": (1.0, 100)}
    if case == "no_counters":
        counters = None
    elif case == "counter_missing":     # the parent's program
        del counters[counter]
    elif case == "no_launch":
        counters[launches] = 0
    elif case == "kernel_missing":
        del kernels[kernel]
    elif case == "no_device_time":
        kernels[kernel] = (0.0, 4)
    got = read(metric, _record(counters, None if case == "no_trace"
                               else kernels))
    assert got is None
    # and a share where both are there, never 0
    assert read(metric, _record({counter: 1.0, launches: 4},
                                {kernel: (10.0, 4)})) > 0
