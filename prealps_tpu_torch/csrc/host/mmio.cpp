// Fast MatrixMarket coordinate reader (C ABI, loaded via ctypes).
//
// Native replacement for the reference's loader (reference:
// utils/cplm_light/cplm_matcsr.c CPLM_LoadMatrixMarket and
// utils/iterativeKernels mmio.c). Supports "matrix coordinate real
// {general|symmetric}" and pattern variants; symmetric storage is expanded.
//
// Two-phase API so Python owns the allocations:
//   prealps_mm_open(path, handle_out, n_out, m_out, nnz_expanded_out)
//   prealps_mm_fill(handle, row, col, val)  // COO, 0-based, expanded
//   (handle freed by fill or prealps_mm_close)

#include <cctype>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {
struct MMData {
  int64_t n = 0, m = 0;
  std::vector<int32_t> row, col;
  std::vector<double> val;
};
}  // namespace

extern "C" {

int prealps_mm_open(const char* path, void** handle_out, int64_t* n_out,
                    int64_t* m_out, int64_t* nnz_out) {
  FILE* f = std::fopen(path, "r");
  if (!f) return 1;
  char line[1 << 16];
  if (!std::fgets(line, sizeof line, f)) { std::fclose(f); return 2; }
  bool symmetric = false, pattern = false;
  {
    std::string header(line);
    for (auto& c : header) c = static_cast<char>(std::tolower(c));
    if (header.find("matrixmarket") == std::string::npos ||
        header.find("coordinate") == std::string::npos) {
      std::fclose(f);
      return 3;
    }
    symmetric = header.find("symmetric") != std::string::npos;
    pattern = header.find("pattern") != std::string::npos;
    // only real/integer/pattern fields: complex files would otherwise be
    // silently mis-parsed (imaginary parts consumed as the next row index)
    if (!pattern && header.find("real") == std::string::npos &&
        header.find("integer") == std::string::npos) {
      std::fclose(f);
      return 6;
    }
  }
  // skip comments
  long pos = std::ftell(f);
  while (std::fgets(line, sizeof line, f)) {
    if (line[0] != '%') break;
    pos = std::ftell(f);
  }
  std::fseek(f, pos, SEEK_SET);
  int64_t n, m, nnz;
  if (std::fscanf(f, "%lld %lld %lld", (long long*)&n, (long long*)&m,
                  (long long*)&nnz) != 3) {
    std::fclose(f);
    return 4;
  }
  auto* d = new MMData;
  d->n = n;
  d->m = m;
  d->row.reserve(symmetric ? 2 * nnz : nnz);
  d->col.reserve(symmetric ? 2 * nnz : nnz);
  d->val.reserve(symmetric ? 2 * nnz : nnz);
  for (int64_t k = 0; k < nnz; ++k) {
    long long i, j;
    double v = 1.0;
    int got = pattern ? std::fscanf(f, "%lld %lld", &i, &j)
                      : std::fscanf(f, "%lld %lld %lf", &i, &j, &v);
    if (got < 2) { delete d; std::fclose(f); return 5; }
    d->row.push_back(static_cast<int32_t>(i - 1));
    d->col.push_back(static_cast<int32_t>(j - 1));
    d->val.push_back(v);
    if (symmetric && i != j) {
      d->row.push_back(static_cast<int32_t>(j - 1));
      d->col.push_back(static_cast<int32_t>(i - 1));
      d->val.push_back(v);
    }
  }
  std::fclose(f);
  *handle_out = d;
  *n_out = d->n;
  *m_out = d->m;
  *nnz_out = static_cast<int64_t>(d->val.size());
  return 0;
}

int prealps_mm_fill(void* handle, int32_t* row, int32_t* col, double* val) {
  auto* d = static_cast<MMData*>(handle);
  std::memcpy(row, d->row.data(), d->row.size() * sizeof(int32_t));
  std::memcpy(col, d->col.data(), d->col.size() * sizeof(int32_t));
  std::memcpy(val, d->val.data(), d->val.size() * sizeof(double));
  delete d;
  return 0;
}

void prealps_mm_close(void* handle) { delete static_cast<MMData*>(handle); }

}  // extern "C"
