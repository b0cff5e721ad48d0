// pcseg_io: the port's native SemanticKITTI scan and label readers and its
// spherical range projection.
//
// Host C++ (no CUDA), built with g++ at first use and called through ctypes
// by openpcseg_torch/native.py; the nvcc build (ops/cuda_lib.py) takes only
// the .cu files of this directory. The two readers keep the semantics of
// the JAX package's native readers: at most `cap` rows are read, the label
// ids are the lower 16 bits remapped through a lookup table, an id outside
// the table becomes 0, and the return value is the file's row count (which
// may exceed cap), or -1 on an IO error. range_project is the JAX package's
// own, operation for operation: built with the same flags (no -ffast-math,
// no -march) it computes the same float32 bits on one machine.
//
// Build: g++ -O3 -shared -fPIC pcseg_io.cpp -o libpcseg_io.so
#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
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

// Spherical range projection with closest-point z-buffer
// (reference laserscan.py:174-238) writing the packed 6-channel input
// tensor [x/50, y/50, z/3, intensity, depth/80, mask] directly
// (reference semantickitti_rv.py:284-301). pts is [n, 4] (x, y, z,
// intensity); labels and label_out may be null. Every point's pixel goes
// to px_out/py_out; of two points of one pixel the nearer wins, and of two
// at the same depth the first.
void range_project(const float* pts, int n, int h, int w, float fov_up_deg,
                   float fov_down_deg, const int32_t* labels,
                   float* scan_out, int32_t* label_out, float* mask_out,
                   int32_t* px_out, int32_t* py_out) {
  const float pi = 3.14159265358979323846f;
  const float fov_up = fov_up_deg / 180.0f * pi;
  const float fov_down = fov_down_deg / 180.0f * pi;
  const float fov = std::fabs(fov_down) + std::fabs(fov_up);

  std::vector<float> best(h * (long)w, -1.0f);  // depth of current winner
  std::memset(scan_out, 0, sizeof(float) * 6 * h * (long)w);
  std::memset(mask_out, 0, sizeof(float) * h * (long)w);
  if (label_out) std::memset(label_out, 0, sizeof(int32_t) * h * (long)w);

  for (int i = 0; i < n; ++i) {
    const float x = pts[i * 4 + 0], y = pts[i * 4 + 1], z = pts[i * 4 + 2];
    const float inten = pts[i * 4 + 3];
    float depth = std::sqrt(x * x + y * y + z * z);
    if (depth < 1e-8f) depth = 1e-8f;
    const float yaw = -std::atan2(y, x);
    float pitch = std::asin(std::max(-1.0f, std::min(1.0f, z / depth)));

    float fx = 0.5f * (yaw / pi + 1.0f) * w;
    float fy = (1.0f - (pitch + std::fabs(fov_down)) / fov) * h;
    int ix = (int)std::floor(fx);
    int iy = (int)std::floor(fy);
    ix = std::max(0, std::min(w - 1, ix));
    iy = std::max(0, std::min(h - 1, iy));
    px_out[i] = ix;
    py_out[i] = iy;

    const long pix = (long)iy * w + ix;
    if (best[pix] >= 0.0f && depth >= best[pix]) continue;  // farther: lose
    best[pix] = depth;
    float* sp = scan_out + pix * 6;
    sp[0] = x / 50.0f;
    sp[1] = y / 50.0f;
    sp[2] = z / 3.0f;
    sp[3] = inten;
    sp[4] = depth / 80.0f;
    sp[5] = 1.0f;
    mask_out[pix] = 1.0f;
    if (label_out && labels) label_out[pix] = labels[i];
  }
}

}  // extern "C"
