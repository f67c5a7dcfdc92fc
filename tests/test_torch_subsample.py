"""The mask producer of the port's native subsample loop
(``fqtk_tpu_torch.runtime.subsample._run_subsample_native``): its error path
must never block on the bounded mask queue once the consumer has left.

The engine and the mask stream are stand-ins (no files are read): the tests
drive the producer / consumer hand-over only.  Each run happens on a helper
thread that the test joins with a timeout of its own, so a hang fails the
test instead of stalling the suite."""

import queue
import threading
import time

import numpy as np

from fqtk_tpu_torch.io import native as native_io
from fqtk_tpu_torch.runtime import subsample as sub

TIMEOUT_S = 20.0


class FakeEngine:
    """Stands in for ``NativeSubsampleEngine``: ``script(mask)`` gives each
    call's ``(consumed, kept)``."""

    def __init__(self, script):
        self.script = script
        self.closed = False

    def __call__(self, threads, compression_level):
        return self

    def add_input(self, inp, out):
        pass

    def configure(self, check_names):
        pass

    def process_chunk(self, mask):
        return self.script(mask)

    def finish(self):
        pass

    def stats(self):
        return {}

    def close(self):
        self.closed = True


class FakeMask:
    """Stands in for ``NativeChaChaMask``: ``draw(n_call, take)`` gives the
    mask or raises."""

    def __init__(self, draw):
        self.draw = draw
        self.calls = 0

    def __call__(self, seed):
        return self

    def keep_mask(self, take, fraction):
        self.calls += 1
        return self.draw(self.calls, take)


def run_in_thread(monkeypatch, engine, mask):
    """``_run_subsample_native`` on a helper thread: ``(finished, result or
    exception)`` after at most ``TIMEOUT_S``."""
    monkeypatch.setattr(native_io, "NativeSubsampleEngine", engine)
    monkeypatch.setattr(native_io, "NativeChaChaMask", mask)
    cfg = sub.SubsampleConfig(inputs=["a.fq"], output="out/pre", fraction=0.5, seed=1)
    box = []

    def target():
        try:
            box.append(sub._run_subsample_native(cfg, None, 1))
        except BaseException as e:  # handed to the test
            box.append(e)

    th = threading.Thread(target=target, daemon=True)
    th.start()
    th.join(TIMEOUT_S)
    return not th.is_alive(), (box[0] if box else None)


def ones(_n, take):
    return np.ones(take, dtype=np.uint8)


def test_fake_run_counts(monkeypatch):
    # three full chunks, then a short one: EOF
    seen = []

    def script(mask):
        seen.append(len(mask))
        return (len(mask), int(mask.sum())) if len(seen) < 4 else (10, 10)

    engine = FakeEngine(script)
    done, res = run_in_thread(monkeypatch, engine, FakeMask(ones))
    assert done and isinstance(res, sub.SubsampleResult), res
    assert res.total_read == sum(seen[:3]) + 10 == res.total_kept
    assert engine.closed


def test_producer_error_reaches_the_consumer(monkeypatch):
    def draw(n, take):
        if n == 2:
            raise MemoryError("no room for the mask")
        return np.ones(take, dtype=np.uint8)

    engine = FakeEngine(lambda mask: (len(mask), len(mask)))
    done, res = run_in_thread(monkeypatch, engine, FakeMask(draw))
    assert done, "the run hung"
    assert isinstance(res, MemoryError) and engine.closed


def test_producer_error_after_the_consumer_left_does_not_hang(monkeypatch):
    """``draw_mask`` raises while the mask queue is full and the consumer has
    left its loop and finished draining: the producer must give up its
    error marker (``stop`` is set) instead of blocking on the full queue,
    or ``producer.join()`` never returns."""
    fourth_draw = threading.Event()
    consumer_left = threading.Event()

    class NoDrainQueue(queue.Queue):
        # the consumer's drain finds nothing: as if it ran before the
        # producer filled the queue again
        def get_nowait(self):
            if self.maxsize == 2:
                raise queue.Empty
            return super().get_nowait()

    monkeypatch.setattr(queue, "Queue", NoDrainQueue)

    def draw(n, take):
        if n < 4:
            return np.ones(take, dtype=np.uint8)
        # masks 2 and 3 fill the queue; the consumer is about to leave
        fourth_draw.set()
        assert consumer_left.wait(TIMEOUT_S)
        time.sleep(0.5)  # let the consumer set `stop` and reach the join
        raise MemoryError("no room for the mask")

    def script(mask):
        assert fourth_draw.wait(TIMEOUT_S)
        consumer_left.set()
        return 0, 0  # fewer than asked: EOF, the consumer leaves its loop

    engine = FakeEngine(script)
    mask = FakeMask(draw)
    done, res = run_in_thread(monkeypatch, engine, mask)
    assert mask.calls == 4
    assert done, "producer.join() hung: the error path blocked on the full queue"
    assert isinstance(res, sub.SubsampleResult) and res.total_read == 0
    assert engine.closed

