"""The port's DistributedLogger (``trainer/logger.py``): a mirror of
``tests/trainer/test_logger.py``, the rank read from ``torch.distributed``:
rank-0 filtering, the cached rank lookup (``utils.procindex.RankFilter``),
level routing, handler idempotency. Host-only."""
import logging
import uuid

import torch.distributed as dist

from pipegoose_tpu_torch.trainer.logger import DistributedLogger
from pipegoose_tpu_torch.utils.procindex import RankFilter


def _fresh_name():
    # logging.getLogger caches by name process-wide; unique names keep
    # handler assertions independent across tests
    return f"pgt_torch_test_{uuid.uuid4().hex[:8]}"


def _fake_rank(monkeypatch, rank, calls=None):
    def get_rank():
        if calls is not None:
            calls["n"] += 1
        return rank

    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_rank", get_rank)


def test_info_warning_error_paths_emit(capsys):
    log = DistributedLogger(name=_fresh_name())
    log.info("hello-info")
    log.warning("hello-warning")
    log.error("hello-error")
    out = capsys.readouterr().out
    assert "hello-info" in out and "INFO" in out
    assert "hello-warning" in out and "WARNING" in out
    assert "hello-error" in out and "ERROR" in out


def test_debug_below_default_level_is_dropped(capsys):
    log = DistributedLogger(name=_fresh_name())          # default INFO
    log.debug("quiet")
    assert "quiet" not in capsys.readouterr().out
    log2 = DistributedLogger(name=_fresh_name(), level=logging.DEBUG)
    log2.debug("loud")
    assert "loud" in capsys.readouterr().out


def test_rank_filtering(capsys, monkeypatch):
    # no process group: this process is rank 0
    DistributedLogger(name=_fresh_name(), rank=0).info("solo-rank0")
    DistributedLogger(name=_fresh_name(), rank=1).info("solo-rank1")
    out = capsys.readouterr().out
    assert "solo-rank0" in out and "solo-rank1" not in out
    # rank 1 of a process group: rank=1 logs, rank=0 doesn't, None always does
    _fake_rank(monkeypatch, 1)
    DistributedLogger(name=_fresh_name(), rank=0).info("from-rank0")
    DistributedLogger(name=_fresh_name(), rank=1).info("from-rank1")
    DistributedLogger(name=_fresh_name(), rank=None).info("from-any")
    out = capsys.readouterr().out
    assert "from-rank0" not in out
    assert "from-rank1" in out
    assert "from-any" in out


def test_rank_is_cached_after_first_lookup(monkeypatch):
    calls = {"n": 0}
    _fake_rank(monkeypatch, 0, calls)
    log = DistributedLogger(name=_fresh_name(), rank=0)
    assert calls["n"] == 0        # construction touches no process group
    log.info("a")
    log.info("b")
    log.warning("c")
    assert calls["n"] == 1        # one lookup, cached thereafter
    calls["n"] = 0
    f = RankFilter(0)
    assert f() and f() and calls["n"] == 1
    calls["n"] = 0
    assert RankFilter(None)()     # rank=None never needs the rank
    assert calls["n"] == 0


def test_no_group_is_not_cached(monkeypatch):
    """Before a process group is up the rank is 0 and nothing is cached:
    a filter built early sees the rank the group gives later."""
    f = RankFilter(1)
    assert not f()
    _fake_rank(monkeypatch, 1)
    assert f()


def test_handlers_not_duplicated_on_reconstruction(capsys):
    name = _fresh_name()
    DistributedLogger(name=name).info("once")
    DistributedLogger(name=name).info("twice")
    out = capsys.readouterr().out
    assert out.count("once") == 1
    assert out.count("twice") == 1
    stream_handlers = [
        h for h in logging.getLogger(name).handlers
        if isinstance(h, logging.StreamHandler)
        and not isinstance(h, logging.FileHandler)
    ]
    assert len(stream_handlers) == 1


def test_logfile_handler_writes_and_deduplicates(tmp_path):
    name = _fresh_name()
    path = str(tmp_path / "train.log")
    log = DistributedLogger(name=name, logfile=path)
    log.info("to-file")
    DistributedLogger(name=name, logfile=path).info("again")
    file_handlers = [
        h for h in logging.getLogger(name).handlers
        if isinstance(h, logging.FileHandler)
    ]
    assert len(file_handlers) == 1
    for h in file_handlers:
        h.flush()
    text = open(path).read()
    assert text.count("to-file") == 1
    assert text.count("again") == 1


def test_no_propagation_to_root(capsys):
    records = []

    class Probe(logging.Handler):
        def emit(self, record):
            records.append(record.getMessage())

    probe = Probe()
    logging.getLogger().addHandler(probe)
    try:
        DistributedLogger(name=_fresh_name()).info("contained")
    finally:
        logging.getLogger().removeHandler(probe)
    assert "contained" not in records
    assert "contained" in capsys.readouterr().out
