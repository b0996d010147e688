"""The reader of ``step.h2d.hidden_share`` on synthetic span records: 0 for
a copy in one piece before the backbone, the exact share for chunks
partly under the backbone of the chunk before (overlapping spans counted
once, grandchildren not at all), the median over the newest profiled
steps, and nothing where there are no spans."""
import sys
import types

import pytest

from benchmark import harness, program_spans

read = harness.reader_of("step.h2d.hidden_share")


def _rec(name, id_, parent, root, start, end):
    return {"name": name, "id": id_, "parent": parent, "root": root,
            "host_ms": end - start, "device_ms": end - start,
            "start_ms": start, "end_ms": end}


def _run(profiled=2):
    return types.SimpleNamespace(mix={"profiled_batches": profiled})


def _spans(monkeypatch, records):
    module = types.ModuleType(program_spans.MODULE)
    module.spans = lambda: records
    monkeypatch.setitem(sys.modules, program_spans.MODULE, module)


def _step(base, children):
    """A ``step`` root at id ``base`` over [0, 100] and its children
    [(name, start, end)], ids after it."""
    return [_rec("step", base, None, base, 0, 100)] + [
        _rec(name, base + 1 + i, base, base, a, b)
        for i, (name, a, b) in enumerate(children)]


def test_serial_copy_reads_zero(monkeypatch):
    _spans(monkeypatch, _step(0, [("step.h2d", 0, 40),
                                  ("hmr.backbone", 40, 90),
                                  ("hmr.ief", 90, 95)]))
    assert read(_run()) == 0.0


def test_chunks_partly_under_the_backbone(monkeypatch):
    """Three copies of 10 ms: the first alone, the second 8 ms under the
    first backbone, the third 8 ms under the second, whose span overlaps
    another child's (counted once); a grandchild adds nothing."""
    records = _step(0, [("step.h2d", 0, 10), ("hmr.backbone", 10, 20),
                        ("step.h2d", 12, 22), ("hmr.backbone", 22, 32),
                        ("step.h2d", 24, 34), ("other", 23, 30),
                        ("hmr.backbone", 34, 44)])
    records.append(_rec("inner", 99, 3, 0, 20, 24))
    _spans(monkeypatch, records)
    assert read(_run()) == pytest.approx(100.0 * 16 / 30)


def test_median_over_the_newest_steps(monkeypatch):
    records = (_step(0, [("step.h2d", 0, 10), ("hmr.backbone", 0, 10)])
               + _step(10, [("step.h2d", 0, 10), ("hmr.backbone", 5, 20)])
               + _step(20, [("step.h2d", 0, 10), ("hmr.backbone", 8, 20)])
               + _step(30, [("step.h2d", 0, 10), ("hmr.backbone", 2, 20)]))
    _spans(monkeypatch, records)
    assert read(_run(3)) == pytest.approx(50.0)
    assert read(_run(1)) == pytest.approx(80.0)


def test_nothing_to_read(monkeypatch):
    _spans(monkeypatch, _step(0, [("hmr.backbone", 0, 10)]))
    assert read(_run()) is None
    _spans(monkeypatch, [])
    assert read(_run()) is None
    monkeypatch.setitem(sys.modules, program_spans.MODULE,
                        types.ModuleType(program_spans.MODULE))
    assert read(_run()) is None
