# Convenience wrapper (reference parity: GNUmakefile's `make run` renders
# scenes/sphere.txt). CPU env vars apply only to `test`.

PY ?= python

run:
	$(PY) -m project3_cuda_path_tracer_tpu scenes/sphere.txt

cornell:
	$(PY) -m project3_cuda_path_tracer_tpu scenes/cornell.txt

bench:
	$(PY) bench.py

native:
	$(MAKE) -C native

cuda:
	$(MAKE) -C native cuda

smoke:
	$(PY) chip_smoke.py

test:
	env JAX_PLATFORMS=cpu \
	  XLA_FLAGS=--xla_force_host_platform_device_count=8 \
	  $(PY) -m pytest tests/ -q

# Fast iteration loop: everything except @pytest.mark.slow (golden render,
# multiprocess meshes, statistical RMSE comparisons), 4-way parallel via
# pytest-xdist — measured ~6-7 min on the 4-core box vs ~25 min for the
# full serial suite. `make test` stays serial and complete.
test-fast:
	env JAX_PLATFORMS=cpu \
	  XLA_FLAGS=--xla_force_host_platform_device_count=8 \
	  $(PY) -m pytest tests/ -q -m "not slow" -n 4

.PHONY: run cornell bench native cuda smoke test test-fast
