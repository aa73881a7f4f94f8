"""The port's spans and counters (``wicca_tpu_torch.utils.timing``) on the
CPU: off, a span is one shared no-op and the registry stays as it is; on
(while a ``torch.profiler`` session records), each span is a ``wicca.*``
range of the session, nested in its caller's, with its ``args``, and the
registry's seconds and calls agree with the session's. The codec, the
container and the harness name their stages, and the link's counters hold
the bytes each hand-over moved."""

import concurrent.futures
import json
import sys
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from tests.test_torch_harness import classifiers, data_folder  # noqa: F401 (fixtures)
from wicca_tpu_torch import QuantSpec, decode, encode
from wicca_tpu_torch.codec import container, pipeline
from wicca_tpu_torch.harness.processor import ClassifierProcessor
from wicca_tpu_torch.utils import timing

CPU = dict(device="cpu")


@pytest.fixture(autouse=True)
def empty_registry():
    timing.reset()
    yield
    timing.reset()


def _session(**kw):
    return profile(activities=[ProfilerActivity.CPU], **kw)


def _ranges(prof) -> dict:
    """``{name: [FunctionEvent]}`` of the session's ``wicca.*`` ranges."""
    out: dict = {}
    for e in prof.events():
        if e.name.startswith("wicca."):
            out.setdefault(e.name, []).append(e)
    return out


def _frame(shape=(3, 64, 96), seed=0):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


def test_off_a_span_is_the_shared_no_op_and_records_nothing():
    assert not timing.recording()
    before = timing.snapshot()
    assert timing.span("a") is timing.span("b", args="x")
    with timing.span("a"):
        timing.count("c", 3)
    encode(_frame(), levels=3, **CPU)
    assert timing.snapshot() == before == {"spans": {}, "counters": {}}


def test_the_profiler_flag_flips_with_a_session():
    """The private flag that ``recording`` reads, as the installed torch
    keeps it."""
    from torch.autograd import profiler

    assert profiler._is_profiler_enabled is False and not timing.recording()
    with _session():
        assert profiler._is_profiler_enabled is True and timing.recording()
    assert profiler._is_profiler_enabled is False and not timing.recording()


def test_ranges_nest_carry_their_args_and_match_the_registry():
    with _session(record_shapes=True) as prof:
        with timing.span("outer"):
            for i in range(3):
                with timing.span("inner", args=f"img_{i}.png"):
                    time.sleep(0.002)
        timing.count("things", 2)
        timing.count("things", 0.5)
    ranges = _ranges(prof)
    assert len(ranges["wicca.outer"]) == 1 and len(ranges["wicca.inner"]) == 3
    assert all(e.cpu_parent is ranges["wicca.outer"][0] for e in ranges["wicca.inner"])
    kw = [e.kwinputs() for e in prof.profiler.kineto_results.events() if e.name() == "wicca.inner"]
    assert sorted(k["args"] for k in kw) == ["img_0.png", "img_1.png", "img_2.png"]
    snap = timing.snapshot()
    assert snap["counters"] == {"things": 2.5}
    for name, events in ranges.items():
        seconds, calls = snap["spans"][name.removeprefix("wicca.")]
        assert calls == len(events)
        in_session = sum(e.time_range.elapsed_us() for e in events) / 1e6
        assert seconds <= in_session and seconds == pytest.approx(in_session, rel=0.05)  # timed inside the range


@pytest.mark.parametrize("n", [1, 500])
def test_eight_threads_count_every_span(n):
    go = threading.Barrier(8)

    def work():
        go.wait()
        for _ in range(n):
            with timing.span("threaded"):
                timing.count("threaded.n", 1)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)  # switch threads often, so that a lost update would show
    try:
        with _session():
            threads = [threading.Thread(target=work) for _ in range(8)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    snap = timing.snapshot()
    assert snap["spans"]["threaded"][1] == 8 * n and snap["counters"]["threaded.n"] == 8 * n


def test_encode_and_decode_name_their_passes_and_count_the_upload():
    """Haar takes its launch plan on the CPU too: each call counts its plan,
    and the passes (the plain twins there) run inside the codec's span with
    no wrapper's span of their own."""
    pipeline._ENCODE_PLANS.clear()
    pipeline._DECODE_PLANS.clear()
    x = _frame()
    with _session() as prof:
        stream = encode(x, levels=5, spec=QuantSpec(base_step=1.0), **CPU)
        decode(stream, emit_u8=True)
    ranges = _ranges(prof)
    assert len(ranges["wicca.codec.encode"]) == len(ranges["wicca.codec.decode"]) == 1
    assert not [name for name in ranges if name.startswith("wicca.ops.")]
    snap = timing.snapshot()
    # the numpy frame handed to the device, and a new plan for each call
    assert snap["counters"] == {"link.up_bytes": x.nbytes, "codec.plan_miss": 2}
    assert snap["spans"]["codec.encode"][1] == snap["spans"]["codec.decode"][1] == 1


@pytest.mark.parametrize("quality_layers", [1, 3])
def test_the_container_names_its_stages_and_the_link_its_bytes(quality_layers):
    x = _frame((3, 128, 96))
    stream = encode(x, levels=3, spec=QuantSpec(base_step=2.0), **CPU)
    with _session() as prof:
        data = container.serialize(stream, quality_layers=quality_layers)
        back = container.deserialize(data, **CPU)
    ranges = _ranges(prof)
    for stage in ("entropy_encode", "assemble", "parse", "entropy_decode"):
        assert len(ranges[f"wicca.container.{stage}"]) == 1, stage
    assert [e.name for e in ranges["wicca.link.down"]] == ["wicca.link.down"]
    snap = timing.snapshot()["counters"]
    assert snap["link.down_bytes"] == stream.num_bytes()
    assert snap["link.up_bytes"] == back.num_bytes() == stream.num_bytes()
    assert snap["container.serialized_mp"] == snap["container.deserialized_mp"] == 128 * 96 / 1e6
    assert decode(back, emit_u8=True).shape == x.shape


def test_a_harness_run_names_its_stages_waits_and_loads(data_folder, classifiers, tmp_path):  # noqa: F811
    with _session() as prof:
        ClassifierProcessor(data_folder, transform_depth=2, results_folder=tmp_path, log_info=False,
                            batch_size=4, **CPU).process_classifiers(classifiers)
    ranges, snap = _ranges(prof), timing.snapshot()
    for stage in ("decode", "icon_dwt", "wait_classifiers", "results"):  # the main thread's
        assert f"wicca.harness.{stage}" in ranges, stage
    assert snap["spans"]["harness.icon_dwt"][1] == snap["spans"]["harness.wait_classifiers"][1] == 2  # 4 + 2 images
    for span in ("harness.resize", "harness.inference", "model.upload", "model.forward", "model.fetch"):
        assert span in snap["spans"], span  # classifier threads: in the registry, not in this session
    assert snap["spans"]["data.load_image"][1] == 6
    heights = [96 + 16 * i for i in range(6)]
    assert snap["counters"]["data.decoded_mp"] == pytest.approx(sum(h * 128 for h in heights) / 1e6)
    assert snap["counters"]["model.images"] == 12  # each image and its icon
    # the float32 NHWC batches (the icon route hands a frame over only on a card)
    assert snap["counters"]["link.up_bytes"] == 12 * 64 * 64 * 3 * 4
    assert snap["counters"]["link.down_bytes"] == 12 * 1000 * 4  # the logits
    stages = json.loads((tmp_path / "depth-2" / "run-metrics.json").read_text())["stage_seconds"]
    assert {"decode", "icon_dwt", "resize", "inference", "wait_classifiers", "results"} == set(stages)


def test_trace_records_a_range_opened_on_a_pool_thread(tmp_path):
    def work():
        with timing.span("pooled"):
            torch.ones(4).sum()

    with timing.trace(tmp_path / "t") as prof:
        with concurrent.futures.ThreadPoolExecutor(2) as pool:
            pool.submit(work).result()
    assert "wicca.pooled" in _ranges(prof)
    assert (tmp_path / "t" / "trace.json").is_file()
