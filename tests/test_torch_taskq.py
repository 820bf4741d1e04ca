"""The port's task queue (``fraud_detection_tpu_torch.service.taskq``) on
sqlite: the six delivery cases of the JAX package's ``tests/test_taskq.py``
(send/claim/ack, acks_late redelivery, the retry ladder to FAILED, the
countdown, FIFO, depth counting expired claims), ``nack``'s two idempotency
guards, and one broker file written by the JAX package's broker and read by
the port's (the schemas are the same)."""

import time

import pytest
import torch

from fraud_detection_tpu.service.taskq import Broker as JaxBroker
from fraud_detection_tpu_torch.service import metrics
from fraud_detection_tpu_torch.service.db import ResultsDB
from fraud_detection_tpu_torch.service.taskq import (
    CLAIMED,
    DONE,
    FAILED,
    QUEUED,
    Broker,
)

torch.set_num_threads(1)


@pytest.fixture()
def broker(tmp_path):
    b = Broker(f"sqlite:///{tmp_path}/q.db")
    yield b
    b.close()


def test_send_claim_ack(broker):
    b = broker
    tid = b.send_task("t", [1, "x"], correlation_id="c1")
    assert b.depth() == 1
    assert b.get_status(tid) == QUEUED
    task = b.claim("w1")
    assert task.id == tid
    assert task.args == [1, "x"]
    assert task.correlation_id == "c1"
    assert b.get_status(tid) == CLAIMED
    assert b.depth() == 0  # claimed within visibility window
    b.ack(task.id)
    assert b.get_status(tid) == DONE
    assert b.claim("w1") is None


def test_acks_late_redelivery_after_worker_death(broker):
    """A claimed-but-never-acked task (dead worker) becomes deliverable again
    once the visibility timeout lapses — at-least-once, zero loss — and the
    redelivery is counted."""
    b = broker
    tid = b.send_task("t", [])
    before = metrics.taskq_expired_claims.get()
    t1 = b.claim("w1", visibility_timeout=0.05)
    assert t1 is not None
    assert b.claim("w2") is None  # invisible while claimed
    time.sleep(0.06)
    t2 = b.claim("w2")
    assert t2 is not None and t2.id == tid
    assert b.expired_claims == b.redeliveries == 1
    assert metrics.taskq_expired_claims.get() == before + 1


def test_retry_backoff_and_terminal_failure(broker):
    b = broker
    tid = b.send_task("t", [], max_retries=2)
    for attempt in range(2):
        task = b.claim("w")
        assert task is not None and task.attempts == attempt
        retried = b.nack(task.id, countdown=0.0, error=f"boom {attempt}")
        assert retried is True
    task = b.claim("w")
    assert b.nack(task.id, countdown=0.0, error="final") is False
    assert b.get_status(tid) == FAILED
    assert b.claim("w") is None
    assert b.redeliveries == 2  # the two nack-retry deliveries


def test_countdown_delays_redelivery(broker):
    b = broker
    b.send_task("t", [])
    task = b.claim("w")
    b.nack(task.id, countdown=0.08, error="later")
    assert b.claim("w") is None  # not yet visible
    time.sleep(0.09)
    assert b.claim("w") is not None


def test_fifo_order(broker):
    b = broker
    ids = [b.send_task("t", [i]) for i in range(3)]
    got = [b.claim("w").id for _ in range(3)]
    assert got == ids


def test_depth_counts_expired_claims(broker):
    b = broker
    b.send_task("t", [])
    b.claim("w", visibility_timeout=0.01)
    time.sleep(0.02)
    assert b.depth() == 1


def test_nack_from_a_worker_whose_claim_was_redelivered_is_refused(broker):
    """The ``claimed_by`` guard: worker A's claim lapsed and worker B holds
    the task; A's late nack must not requeue it out from under B."""
    b = broker
    tid = b.send_task("t", [], max_retries=0)
    a = b.claim("A", visibility_timeout=0.01)
    time.sleep(0.02)
    held = b.claim("B")
    assert held.id == a.id == tid
    # max_retries=0: a nack that went through would mark it FAILED
    assert b.nack(tid, 0.0, "late", expected_attempts=a.attempts, claimed_by="A") is True
    assert b.get_status(tid) == CLAIMED
    assert b.nack(tid, 0.0, "real", expected_attempts=held.attempts, claimed_by="B") is False
    assert b.get_status(tid) == FAILED


def test_duplicate_nack_does_not_advance_attempts_twice(broker):
    """The ``expected_attempts`` guard: a repeated nack of one attempt sees
    the count already advanced and changes nothing."""
    b = broker
    tid = b.send_task("t", [], max_retries=1)
    task = b.claim("w")
    assert b.nack(tid, 0.0, "once", expected_attempts=task.attempts, claimed_by="w") is True
    assert b.nack(tid, 0.0, "again", expected_attempts=task.attempts, claimed_by="w") is True
    assert b.get_status(tid) == QUEUED
    again = b.claim("w")
    assert again.attempts == 1  # advanced once, not twice
    assert b.nack(tid, 0.0, "last", expected_attempts=1, claimed_by="w") is False
    assert b.get_status(tid) == FAILED
    assert b.nack("no-such-task", 0.0, "x") is False


def test_a_broker_file_written_by_the_jax_package_is_read_by_the_port(tmp_path):
    """The same ``tasks`` schema: a JAX producer's task is claimed, acked
    and counted by the port's broker on one file, and the other way round."""
    url = f"sqlite:///{tmp_path}/shared.db"
    jb, pb = JaxBroker(url), Broker(url)
    try:
        tid = jb.send_task("xai_tasks.compute_shap", ["tx", {"a": 1.0}, "c", None],
                           correlation_id="c")
        assert pb.depth() == 1
        t = pb.claim("port-worker")
        assert (t.id, t.args, t.correlation_id) == (tid, ["tx", {"a": 1.0}, "c", None], "c")
        pb.ack(t.id)
        assert jb.get_status(tid) == DONE
        tid2 = pb.send_task("xai_tasks.compute_shap", ["tx2", {}, None])
        t2 = jb.claim("jax-worker")
        assert t2.id == tid2 and t2.args == ["tx2", {}, None]
    finally:
        jb.close()
        pb.close()


@pytest.mark.parametrize("url", ["fraud://127.0.0.1:1", "sentinel://h:1/m", "postgresql://u@h/d",
                                 "redis://h:6379/0"])
def test_unported_schemes_raise(url):
    with pytest.raises(NotImplementedError):
        Broker(url)
    with pytest.raises(NotImplementedError):
        ResultsDB(url)
