# Developer entry points (reference analog: common:Makefile).
PYTHON ?= python

.PHONY: test test-fast bench bench-smoke native entry lint clean

# Two invocations: a single very long pytest process (~450 XLA CPU
# compilations) has twice segfaulted inside XLA's compiler late in the
# run (see CLAUDE.md); splitting bounds per-process compilation count.
# Every test passes in either half.
test:
	$(PYTHON) -m pytest tests/test_[a-i]*.py -q
	$(PYTHON) -m pytest tests/test_[j-z]*.py -q

test-fast:
	$(PYTHON) -m pytest tests/ -q -m "not slow"

bench:
	$(PYTHON) bench.py

bench-smoke:
	$(PYTHON) bench.py --smoke

native:
	$(PYTHON) setup.py build_native

entry:
	$(PYTHON) __graft_entry__.py

clean:
	rm -rf build dist *.egg-info common_tpu/native/partition_prebuilt.so
	find . -name __pycache__ -type d -exec rm -rf {} +
