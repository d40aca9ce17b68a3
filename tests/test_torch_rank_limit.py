"""The port's tests join their spawned ranks within a limit
(``torch_port_util.RankGroup``): a rank still running at the limit is
ended and fails its test, named, with what it last wrote and where it
was; ranks that exit in time pass."""

import time

import pytest

from torch_port_util import RankGroup, log_tail

START_WAIT = 60.0  # seconds a loaded machine may take to start a rank


def nap(rank: int, late_rank: int, seconds: float) -> None:
    """Rank ``late_rank`` sleeps ``seconds``; the others exit at once."""
    print(f"rank {rank} started", flush=True)
    if rank == late_rank:
        time.sleep(seconds)


def _until(cond, what):
    deadline = time.monotonic() + START_WAIT
    while not cond():
        assert time.monotonic() < deadline, what
        time.sleep(0.05)


@pytest.mark.parametrize("late", [False, True], ids=["in_time", "late"])
def test_rank_group_joins_within_its_limit(tmp_path, late):
    logs = tmp_path / "logs"
    if not late:
        group = RankGroup(nap, (1, 0.0), 2, logs, limit=120.0)
        try:
            group.join()
        finally:
            group.close()
        assert (logs / "joined_s").exists()
        assert [log_tail(logs, r) for r in range(2)] == [
            "rank 0 started", "rank 1 started"]
        return
    limit = 5.0
    group = RankGroup(nap, (1, 600.0), 2, logs, limit=limit)
    try:
        # the late rank is asleep and the other has exited, whatever the
        # load (starting a rank imports torch)
        _until(lambda: log_tail(logs, 1) == "rank 1 started",
               "rank 1 did not start")
        _until(lambda: not group.ctx.processes[0].is_alive(),
               "rank 0 did not exit")
        called = time.monotonic()
        with pytest.raises(pytest.fail.Exception,
                           match=r"(?s)^rank 1 of 2 still running 5 s .*"
                                 r"rank 1 last wrote:\nrank 1 started\n.*"
                                 r"line \d+ in nap"):
            group.join()
        assert time.monotonic() < max(group.t0 + limit, called) + 5.0
        assert not any(p.is_alive() for p in group.ctx.processes)
    finally:
        group.close()
