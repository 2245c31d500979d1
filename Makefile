# flagstats build/test/bench orchestration
# (reference counterpart: the root Makefile building bench/utility/
#  generate/inmemory/instrumented_benchmark)

PY ?= python3

# libdeflate: fast whole-buffer BGZF inflate (io/native/bgzf.h). The
# probe try-compiles+links with the ACTUAL compiler — same decision
# rule as native_lib._libdeflate_flags, so a header only visible via
# CPATH//usr/local can never enable bgzf.h's __has_include path without
# the matching link line (ADVICE r04 #1)
# (\043 is '#': a literal # would start a make comment, and make's \#
#  unescaping does not survive into the shell's printf)
DEFLATE := $(shell printf '\043include <libdeflate.h>\nint main(){return 0;}\n' \
  | g++ -x c++ - -ldeflate -o /dev/null 2>/dev/null && echo -ldeflate \
  || echo -DLFS_NO_LIBDEFLATE)

.PHONY: all native test test-gpu smoke bench inmemory clean

all: native

# the artifact name carries a per-host tag (-march=native binaries are
# host-specific on shared checkouts), so delegate to the python builder
# which owns the naming + atomic publish
native:
	$(PY) -c "from libflagstats_tpu.io import native_lib; print(native_lib._build())"

test:
	$(PY) -m pytest tests/ -q

# the gpu-marked tests, on a machine with an NVIDIA GPU
test-gpu:
	$(PY) -m pytest -m gpu tests/ -q

# the whole system once on one GPU (python chip_smoke.py --four-cards
# for the multi-card paths on four)
smoke:
	$(PY) chip_smoke.py

bench:
	$(PY) bench.py

inmemory:
	$(PY) -m libflagstats_tpu inmemory -n 1000000

clean:
	rm -rf build .pytest_cache
	find . -name __pycache__ -type d -exec rm -rf {} +

# ThreadSanitizer stress of the parallel framed-stream decoder and the
# container walkers (producer/pool/main-thread window handoffs)
tsan:
	mkdir -p build
	g++ -O1 -g -fsanitize=thread -std=c++17 -march=native \
	  libflagstats_tpu/io/native/tests/tsan_decode_test.cpp \
	  libflagstats_tpu/io/native/flagstats_io.cpp \
	  libflagstats_tpu/io/native/flagstats_host.cpp \
	  -o build/tsan_decode_test -ldl -pthread
	./build/tsan_decode_test
	g++ -O1 -g -fsanitize=thread -std=c++17 -march=native \
	  libflagstats_tpu/io/native/tests/tsan_walker_test.cpp \
	  libflagstats_tpu/io/native/bam_reader.cpp \
	  libflagstats_tpu/io/native/sam_reader.cpp \
	  libflagstats_tpu/io/native/flagstats_host.cpp \
	  -o build/tsan_walker_test -lz $(DEFLATE) -pthread
	./build/tsan_walker_test

# ASan/UBSan fuzz of the LZ4 decoder against corrupted inputs, plus
# the host flagstat/pospopcnt kernels over exact-length buffers
asan:
	mkdir -p build
	g++ -O1 -g -fsanitize=address,undefined,pointer-overflow -std=c++17 \
	  -march=native \
	  libflagstats_tpu/io/native/tests/asan_fuzz_test.cpp \
	  libflagstats_tpu/io/native/flagstats_io.cpp \
	  libflagstats_tpu/io/native/flagstats_host.cpp \
	  -o build/asan_fuzz_test -ldl -pthread
	./build/asan_fuzz_test
	g++ -O1 -g -fsanitize=address,undefined,pointer-overflow -std=c++17 \
	  -march=native \
	  libflagstats_tpu/io/native/tests/host_kernel_test.cpp \
	  libflagstats_tpu/io/native/flagstats_host.cpp \
	  -o build/host_kernel_test -pthread
	./build/host_kernel_test
	# ISA matrix: the production .so uses -march=native (AVX-512 here),
	# but AVX2-only and scalar hosts take the other #if branches — build
	# and run them explicitly so no tier bit-rots
	g++ -O1 -g -fsanitize=address,undefined,pointer-overflow -std=c++17 \
	  -mavx2 -mno-avx512f \
	  libflagstats_tpu/io/native/tests/host_kernel_test.cpp \
	  libflagstats_tpu/io/native/flagstats_host.cpp \
	  -o build/host_kernel_test_avx2 -pthread
	./build/host_kernel_test_avx2
	g++ -O1 -g -fsanitize=address,undefined,pointer-overflow -std=c++17 \
	  -mno-avx -mno-avx2 -mno-avx512f \
	  libflagstats_tpu/io/native/tests/host_kernel_test.cpp \
	  libflagstats_tpu/io/native/flagstats_host.cpp \
	  -o build/host_kernel_test_scalar -pthread
	./build/host_kernel_test_scalar
	# BAM/BGZF walker fuzz: the walker parses untrusted containers
	g++ -O1 -g -fsanitize=address,undefined,pointer-overflow -std=c++17 \
	  -march=native \
	  libflagstats_tpu/io/native/tests/bam_fuzz_test.cpp \
	  libflagstats_tpu/io/native/bam_reader.cpp \
	  libflagstats_tpu/io/native/flagstats_host.cpp \
	  -o build/bam_fuzz_test -lz $(DEFLATE) -pthread
	./build/bam_fuzz_test
	# SAM-text parser fuzz: untrusted text input
	g++ -O1 -g -fsanitize=address,undefined,pointer-overflow -std=c++17 \
	  -march=native \
	  libflagstats_tpu/io/native/tests/sam_fuzz_test.cpp \
	  libflagstats_tpu/io/native/sam_reader.cpp \
	  libflagstats_tpu/io/native/flagstats_host.cpp \
	  -o build/sam_fuzz_test -lz $(DEFLATE) -pthread
	./build/sam_fuzz_test
	# rANS-4x8 + itf8 + CRAM-walker fuzz: CRAM ingest on hostile input
	g++ -O1 -g -fsanitize=address,undefined,pointer-overflow -std=c++17 \
	  -march=native \
	  libflagstats_tpu/io/native/tests/rans_fuzz_test.cpp \
	  libflagstats_tpu/io/native/rans4x8.cpp \
	  libflagstats_tpu/io/native/cram_reader.cpp \
	  libflagstats_tpu/io/native/flagstats_io.cpp \
	  libflagstats_tpu/io/native/flagstats_host.cpp \
	  -o build/rans_fuzz_test -lz -ldl $(DEFLATE) -pthread
	./build/rans_fuzz_test
