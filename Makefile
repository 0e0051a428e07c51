# Build / test / bench entry points (the L5 tier of SURVEY.md's layer map;
# the reference's equivalents are the Vitis HLS + Vivado tcl scripts).

CXX ?= g++
CXXFLAGS ?= -O3 -std=c++17 -shared -fPIC
NATIVE := csrc/build/libsgrace_host.so

.PHONY: all native test test-fast test-gpu bench smoke clean

all: native

native: $(NATIVE)

$(NATIVE): csrc/sgrace_host.cpp
	mkdir -p csrc/build
	$(CXX) $(CXXFLAGS) -o $@ $<

test: native
	python -m pytest tests/ -q

test-fast: native
	python -m pytest tests/ -q -x -m "not slow"

# tests that need an NVIDIA GPU (skipped by the CPU runs above)
test-gpu: native
	SGRACE_TEST_GPU=1 python -m pytest tests/ -q -m gpu

# main paths on one GPU: compiled, checked, timed (last line is JSON)
smoke: native
	python chip_smoke.py

# benchmark phases on one GPU (one JSON line)
bench: native
	python bench.py

clean:
	rm -rf csrc/build .jax_cache sgracex1_tpu.egg-info build dist
