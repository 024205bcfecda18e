// Native data plane of pvraft_tpu_torch: .npy scene IO and threaded batch
// assembly on the host (no CUDA here). A C++ thread pool reads and
// subsamples the scenes of a batch into numpy buffers that the caller
// allocated, through ctypes: no pickling, no forked processes, no
// allocation per batch on the Python side.
//
// The port's own copy of the JAX package's assembler: the npy parser, the
// xorshift128+ generator, the Fisher-Yates prefix sample and the per-item
// seed are the same, so both libraries give the same bytes for the same
// scenes, seed and epoch.
//
// Scope: float32/float64 little-endian C-order .npy (v1.0/2.0), the only
// layout the preprocessing writes (pc1/pc2 arrays of shape (N, 3)).
//
// Built at first use by pvraft_tpu_torch/native/__init__.py
// (g++ -O3 -std=c++17 -shared -fPIC -pthread).

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

struct NpyInfo {
  long rows = 0;
  long cols = 0;
  long word = 0;      // bytes per element (4 or 8)
  long offset = 0;    // data start within the file
  bool ok = false;
};

// Parse a v1.0/v2.0 .npy header. Returns header info; data follows at
// `offset`. Only little-endian float ('<f4'/'<f8') C-order arrays of rank
// 1 or 2 are accepted.
NpyInfo parse_header(FILE* f) {
  NpyInfo info;
  unsigned char magic[8];
  if (fread(magic, 1, 8, f) != 8) return info;
  if (memcmp(magic, "\x93NUMPY", 6) != 0) return info;
  const int major = magic[6];
  unsigned long hlen = 0;
  unsigned char lenbuf[4];
  if (major == 1) {
    if (fread(lenbuf, 1, 2, f) != 2) return info;
    hlen = lenbuf[0] | (lenbuf[1] << 8);
    info.offset = 10 + static_cast<long>(hlen);
  } else {
    if (fread(lenbuf, 1, 4, f) != 4) return info;
    hlen = lenbuf[0] | (lenbuf[1] << 8) | (lenbuf[2] << 16) |
           (static_cast<unsigned long>(lenbuf[3]) << 24);
    info.offset = 12 + static_cast<long>(hlen);
  }
  std::string header(hlen, '\0');
  if (fread(header.data(), 1, hlen, f) != hlen) return info;

  if (header.find("'fortran_order': True") != std::string::npos) return info;
  if (header.find("'<f4'") != std::string::npos) {
    info.word = 4;
  } else if (header.find("'<f8'") != std::string::npos) {
    info.word = 8;
  } else {
    return info;
  }

  const auto spos = header.find("'shape':");
  if (spos == std::string::npos) return info;
  const auto open = header.find('(', spos);
  const auto close = header.find(')', open);
  if (open == std::string::npos || close == std::string::npos) return info;
  std::string dims = header.substr(open + 1, close - open - 1);
  long vals[2] = {0, 1};
  int n = 0;
  const char* p = dims.c_str();
  while (*p != '\0' && n < 2) {
    while (*p == ' ' || *p == ',') ++p;
    if (*p == '\0') break;
    char* end = nullptr;
    const long v = strtol(p, &end, 10);
    if (end == p) break;
    vals[n++] = v;
    p = end;
  }
  if (n == 0) return info;
  info.rows = vals[0];
  info.cols = (n == 2) ? vals[1] : 1;
  info.ok = true;
  return info;
}

// Read one .npy file into `out` (float32, capacity elements). Returns
// rows on success, negative error code otherwise.
long read_npy_f32(const char* path, float* out, long capacity, long* cols_out) {
  FILE* f = fopen(path, "rb");
  if (f == nullptr) return -1;
  NpyInfo info = parse_header(f);
  if (!info.ok) {
    fclose(f);
    return -2;
  }
  const long total = info.rows * info.cols;
  if (total > capacity) {
    fclose(f);
    return -3;
  }
  if (fseek(f, info.offset, SEEK_SET) != 0) {
    fclose(f);
    return -4;
  }
  if (info.word == 4) {
    if (fread(out, 4, total, f) != static_cast<size_t>(total)) {
      fclose(f);
      return -5;
    }
  } else {
    std::vector<double> tmp(total);
    if (fread(tmp.data(), 8, total, f) != static_cast<size_t>(total)) {
      fclose(f);
      return -5;
    }
    for (long i = 0; i < total; ++i) out[i] = static_cast<float>(tmp[i]);
  }
  fclose(f);
  if (cols_out != nullptr) *cols_out = info.cols;
  return info.rows;
}

// xorshift128+ — deterministic, seedable per (seed, epoch, index).
struct XorShift {
  uint64_t s0, s1;
  explicit XorShift(uint64_t seed) {
    s0 = seed * 0x9E3779B97F4A7C15ULL + 1;
    s1 = (seed ^ 0xDEADBEEFCAFEF00DULL) * 0xBF58476D1CE4E5B9ULL + 1;
    for (int i = 0; i < 8; ++i) next();
  }
  uint64_t next() {
    uint64_t x = s0;
    const uint64_t y = s1;
    s0 = y;
    x ^= x << 23;
    s1 = x ^ y ^ (x >> 17) ^ (y >> 26);
    return s1 + y;
  }
  // Unbiased-enough bounded draw for shuffles.
  long below(long n) { return static_cast<long>(next() % static_cast<uint64_t>(n)); }
};

// Fisher-Yates prefix shuffle: writes a random n_take-subset permutation of
// [0, n) into idx (first n_take entries valid).
void sample_indices(long n, long n_take, uint64_t seed, std::vector<long>* idx) {
  idx->resize(n);
  for (long i = 0; i < n; ++i) (*idx)[i] = i;
  XorShift rng(seed);
  const long limit = n_take < n ? n_take : n;
  for (long i = 0; i < limit; ++i) {
    const long j = i + rng.below(n - i);
    std::swap((*idx)[i], (*idx)[j]);
  }
}

}  // namespace

extern "C" {

// Shape probe: rows/cols of a .npy without reading the payload.
long pvraft_npy_shape(const char* path, long* cols_out) {
  FILE* f = fopen(path, "rb");
  if (f == nullptr) return -1;
  NpyInfo info = parse_header(f);
  fclose(f);
  if (!info.ok) return -2;
  if (cols_out != nullptr) *cols_out = info.cols;
  return info.rows;
}

long pvraft_npy_read_f32(const char* path, float* out, long capacity,
                         long* cols_out) {
  return read_npy_f32(path, out, capacity, cols_out);
}

// Assemble one batch of scenes in parallel.
//
// For each scene i (paths are NUL-separated in pc1_paths/pc2_paths):
//   * read pc1 (N, 3) and pc2 (M, 3);
//   * draw independent subsample permutations of size n_points for each
//     cloud, seeded by (seed, epoch, scene_index[i]) — the semantics of
//     datasets/generic.py:183-190 with deterministic per-item seeding;
//   * write pc1 rows into out_pc1[i], pc2 rows into out_pc2[i], and
//     flow = pc2_full[perm1] - pc1_full[perm1] into out_flow[i]
//     (index-aligned gt, flyingthings3d_hplflownet.py:104-107);
//   * mask is all ones (out_mask[i]).
//
// filter_mode selects an optional row filter applied to the index-aligned
// clouds before subsampling:
//   0 — none (FT3D);
//   1 — KITTI eval filter (kitti_hplflownet.py:81-87): drop rows where both
//       frames are ground (y < -1.4) or either frame is far (z >= 35 m).
//       Requires pc1/pc2 row counts to match (they are index-aligned).
//
// Scenes whose clouds have fewer than n_points rows are reported in
// status[i] = 0 (caller applies the reject-and-advance policy); success is
// status[i] = 1, IO/parse errors are negative (-3: filter_mode=1 with
// misaligned clouds).
void pvraft_load_scene_batch(
    const char* pc1_paths, const char* pc2_paths, const long* scene_indices,
    long n_scenes, long n_points, long max_rows, uint64_t seed, uint64_t epoch,
    int flip_xz, int filter_mode, float* out_pc1, float* out_pc2,
    float* out_mask, float* out_flow, int* status, long n_threads) {
  std::vector<const char*> p1(n_scenes), p2(n_scenes);
  {
    const char* c1 = pc1_paths;
    const char* c2 = pc2_paths;
    for (long i = 0; i < n_scenes; ++i) {
      p1[i] = c1;
      p2[i] = c2;
      c1 += strlen(c1) + 1;
      c2 += strlen(c2) + 1;
    }
  }

  auto work = [&](long i) {
    std::vector<float> buf1(max_rows * 3), buf2(max_rows * 3);
    long cols = 0;
    long n1 = read_npy_f32(p1[i], buf1.data(), max_rows * 3, &cols);
    if (n1 < 0 || cols != 3) {
      status[i] = -1;
      return;
    }
    long n2 = read_npy_f32(p2[i], buf2.data(), max_rows * 3, &cols);
    if (n2 < 0 || cols != 3) {
      status[i] = -2;
      return;
    }
    if (filter_mode == 1) {
      if (n1 != n2) {
        status[i] = -3;
        return;
      }
      long w = 0;
      for (long r = 0; r < n1; ++r) {
        const bool ground =
            buf1[r * 3 + 1] < -1.4f && buf2[r * 3 + 1] < -1.4f;
        const bool near =
            buf1[r * 3 + 2] < 35.0f && buf2[r * 3 + 2] < 35.0f;
        if (ground || !near) continue;
        for (int c = 0; c < 3; ++c) {
          buf1[w * 3 + c] = buf1[r * 3 + c];
          buf2[w * 3 + c] = buf2[r * 3 + c];
        }
        ++w;
      }
      n1 = n2 = w;
    }
    if (n1 < n_points || n2 < n_points) {
      status[i] = 0;  // caller walks to the next scene
      return;
    }
    if (flip_xz != 0) {  // FT3D axis convention (flyingthings3d_hplflownet.py:100-102)
      for (long r = 0; r < n1; ++r) {
        buf1[r * 3 + 0] = -buf1[r * 3 + 0];
        buf1[r * 3 + 2] = -buf1[r * 3 + 2];
      }
      for (long r = 0; r < n2; ++r) {
        buf2[r * 3 + 0] = -buf2[r * 3 + 0];
        buf2[r * 3 + 2] = -buf2[r * 3 + 2];
      }
    }
    const uint64_t item_seed =
        seed * 1000003ULL + epoch * 7919ULL + static_cast<uint64_t>(scene_indices[i]);
    std::vector<long> perm1, perm2;
    sample_indices(n1, n_points, item_seed, &perm1);
    sample_indices(n2, n_points, item_seed ^ 0x5851F42D4C957F2DULL, &perm2);

    float* o1 = out_pc1 + i * n_points * 3;
    float* o2 = out_pc2 + i * n_points * 3;
    float* om = out_mask + i * n_points;
    float* of = out_flow + i * n_points * 3;
    for (long r = 0; r < n_points; ++r) {
      const long s1 = perm1[r];
      const long s2 = perm2[r];
      for (int c = 0; c < 3; ++c) {
        o1[r * 3 + c] = buf1[s1 * 3 + c];
        o2[r * 3 + c] = buf2[s2 * 3 + c];
        // gt flow follows pc1's permutation (generic.py:185-187).
        of[r * 3 + c] = buf2[s1 * 3 + c] - buf1[s1 * 3 + c];
      }
      om[r] = 1.0f;
    }
    status[i] = 1;
  };

  if (n_threads <= 1 || n_scenes <= 1) {
    for (long i = 0; i < n_scenes; ++i) work(i);
    return;
  }
  std::vector<std::thread> pool;
  std::vector<long> next(1, 0);
  // Simple static partition: thread t handles scenes t, t+T, t+2T, ...
  const long T = n_threads < n_scenes ? n_threads : n_scenes;
  pool.reserve(T);
  for (long t = 0; t < T; ++t) {
    pool.emplace_back([&, t]() {
      for (long i = t; i < n_scenes; i += T) work(i);
    });
  }
  for (auto& th : pool) th.join();
}

}  // extern "C"
