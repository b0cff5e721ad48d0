// pcseg_io: the port's native SemanticKITTI scan and label readers.
//
// Host C++ (no CUDA), built with g++ at first use and called through ctypes
// by openpcseg_torch/native.py; the nvcc build (ops/cuda_lib.py) takes only
// the .cu files of this directory. The two readers keep the semantics of
// the JAX package's native readers: at most `cap` rows are read, the label
// ids are the lower 16 bits remapped through a lookup table, an id outside
// the table becomes 0, and the return value is the file's row count (which
// may exceed cap), or -1 on an IO error.
//
// Build: g++ -O3 -shared -fPIC pcseg_io.cpp -o libpcseg_io.so
#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <vector>

extern "C" {

// Load a SemanticKITTI .bin scan (x, y, z, intensity float32 rows) into
// out, at most cap rows.
int load_kitti_scan(const char* path, float* out, int cap) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  fseek(f, 0, SEEK_END);
  long bytes = ftell(f);
  fseek(f, 0, SEEK_SET);
  long n = bytes / (4 * sizeof(float));
  long take = std::min<long>(n, cap);
  size_t got = fread(out, sizeof(float) * 4, take, f);
  fclose(f);
  if ((long)got != take) return -1;
  return (int)n;
}

// Load a .label file (uint32: semantic id in the lower 16 bits, instance id
// in the upper 16) into out, at most cap rows, each semantic id remapped
// through lut[lut_n].
int load_kitti_labels(const char* path, const int32_t* lut, int lut_n,
                      int32_t* out, int cap) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  fseek(f, 0, SEEK_END);
  long bytes = ftell(f);
  fseek(f, 0, SEEK_SET);
  long n = bytes / sizeof(uint32_t);
  long take = std::min<long>(n, cap);
  std::vector<uint32_t> raw(take);
  size_t got = fread(raw.data(), sizeof(uint32_t), take, f);
  fclose(f);
  if ((long)got != take) return -1;
  for (long i = 0; i < take; ++i) {
    int sem = (int)(raw[i] & 0xFFFFu);
    out[i] = (sem < lut_n) ? lut[sem] : 0;
  }
  return (int)n;
}

}  // extern "C"
