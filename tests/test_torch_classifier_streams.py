"""``TorchClassifier``'s streams (``wicca_tpu_torch.models.registry``): a
call runs on a stream lent to it for the call, so calls one after another,
from whichever thread, share one stream and its cached memory, and calls
at the same time get streams of their own."""

import threading

import numpy as np
import pytest
import torch

from wicca_tpu_torch.config.constants import MODEL
from wicca_tpu_torch.models.registry import StreamLender, load_single_model


def _counting_lender():
    made = []

    def make():
        made.append(object())
        return made[-1]

    return StreamLender(make), made


def test_calls_one_after_another_share_one_stream_from_any_thread():
    lender, made = _counting_lender()
    got = []

    def call():
        with lender.lend() as stream:
            got.append(stream)

    for _ in range(4):  # each call on a new thread, as the harness's pool makes one per depth
        t = threading.Thread(target=call)
        t.start()
        t.join()
    assert len(made) == 1 and got == [made[0]] * 4


def test_calls_at_the_same_time_get_streams_of_their_own():
    lender, made = _counting_lender()
    inside = threading.Barrier(3)
    got = []

    def call():
        with lender.lend() as stream:
            got.append(stream)
            inside.wait(timeout=10)  # all three hold a stream at once

    threads = [threading.Thread(target=call) for _ in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(made) == 3 and len({id(s) for s in got}) == 3
    with lender.lend() as stream:  # the three are idle again: no fourth is made
        assert stream in made
    assert len(made) == 3


def test_a_call_that_raises_gives_its_stream_back():
    lender, made = _counting_lender()
    with pytest.raises(RuntimeError):
        with lender.lend():
            raise RuntimeError("a fault in the forward")
    with lender.lend() as stream:
        assert stream is made[0]
    assert len(made) == 1


def _on_a_new_thread(fn):
    out = []
    t = threading.Thread(target=lambda: out.append(fn()))
    t.start()
    t.join()
    return out[0]


@pytest.mark.cuda
def test_successive_calls_from_new_threads_reuse_the_card_s_memory():
    """On a card: after two calls, calls of the same batch shape from new
    threads (each call on a thread of its own, as the harness makes them)
    allocate no more device memory (with a stream per thread, every call
    allocated its activations anew) and give the first call's logits, as do
    two threads at once: within 2e-2 of the largest logit, the zoo's
    bfloat16 tolerance, since cuDNN chooses its convolutions per thread."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    clf = load_single_model("MobileNetV2", shape=(64, 64))[MODEL]
    batch = np.random.default_rng(0).uniform(-1, 1, (5, 64, 64, 3)).astype(np.float32)
    first = _on_a_new_thread(lambda: clf(batch))
    _on_a_new_thread(lambda: clf(batch))
    torch.cuda.synchronize()
    before = torch.cuda.memory_stats()["num_device_alloc"]
    outs = [_on_a_new_thread(lambda: clf(batch)) for _ in range(3)]
    after = torch.cuda.memory_stats()["num_device_alloc"]
    assert after == before, f"{after - before} device allocations in three calls after the first"
    threads = [threading.Thread(target=lambda: outs.append(clf(batch))) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(outs) == 5
    for o in outs:
        np.testing.assert_allclose(o, first, rtol=0, atol=2e-2 * np.abs(first).max())
