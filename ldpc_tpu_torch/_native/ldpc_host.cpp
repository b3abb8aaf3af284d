// Native host core of ldpc_tpu_torch (the PyTorch/CUDA package).
//
// The reference implements its entire host runtime in C++ (GF(2) linear
// algebra in utils/codeword.h, problem construction in algo/qp_admm.h:13-102).
// This library provides the same host-side services for the package —
// bit-packed GF(2) elimination and the cascaded ADMM/LP structure builder —
// exposed as a C ABI consumed from Python via ctypes (NumPy buffers in/out).
// The NumPy bodies in codes/gf2.py and decoders/admm.py compute the same
// outputs; equivalence is unit-tested.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 ldpc_host.cpp -o libldpc_host.so

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

namespace {

using u64 = std::uint64_t;
using u8 = std::uint8_t;

struct BitMatrix {
  int rows, cols, words;
  std::vector<u64> data;  // row-major, cols packed into 64-bit words

  BitMatrix(int r, int c) : rows(r), cols(c), words((c + 63) / 64),
                            data(static_cast<size_t>(r) * words, 0) {}

  u64* row(int i) { return data.data() + static_cast<size_t>(i) * words; }
  const u64* row(int i) const {
    return data.data() + static_cast<size_t>(i) * words;
  }
  bool get(int i, int j) const {
    return (row(i)[j >> 6] >> (j & 63)) & 1ull;
  }
  void set(int i, int j) { row(i)[j >> 6] |= (1ull << (j & 63)); }
  void xor_rows(int dst, int src) {
    u64* d = row(dst);
    const u64* s = row(src);
    for (int w = 0; w < words; ++w) d[w] ^= s[w];
  }
  int first_set(int i) const {
    const u64* r = row(i);
    for (int w = 0; w < words; ++w)
      if (r[w]) return w * 64 + __builtin_ctzll(r[w]);
    return -1;
  }
};

BitMatrix pack(const u8* h, int m, int n) {
  BitMatrix bm(m, n);
  for (int i = 0; i < m; ++i)
    for (int j = 0; j < n; ++j)
      if (h[static_cast<size_t>(i) * n + j] & 1) bm.set(i, j);
  return bm;
}

}  // namespace

extern "C" {

// GF(2) nullspace with the reference's pivoting (utils/codeword.h:97-128):
// pivot of row i = its first nonzero column after prior eliminations; all
// other rows with that bit are XORed. Returns 1 on success and fills g_out
// ((n-m) x n, row-major uint8); returns 0 if any row becomes zero.
int ldpc_gf2_nullspace(const u8* h, int m, int n, u8* g_out) {
  BitMatrix bm = pack(h, m, n);
  std::vector<int> pos(m, -1);
  std::vector<u8> is_main(n, 0);
  for (int i = 0; i < m; ++i) {
    int p = bm.first_set(i);
    if (p < 0) return 0;
    pos[i] = p;
    for (int k = 0; k < m; ++k)
      if (k != i && bm.get(k, p)) bm.xor_rows(k, i);
    is_main[p] = 1;
  }
  const int kdim = n - m;
  std::memset(g_out, 0, static_cast<size_t>(kdim) * n);
  int idx = 0;
  for (int j = 0; j < n; ++j) {
    if (is_main[j]) continue;
    u8* grow = g_out + static_cast<size_t>(idx) * n;
    grow[j] = 1;
    for (int i = 0; i < m; ++i)
      if (bm.get(i, j)) grow[pos[i]] = 1;
    ++idx;
  }
  return 1;
}

int ldpc_gf2_rank(const u8* h, int m, int n) {
  BitMatrix bm = pack(h, m, n);
  int rank = 0;
  for (int col = 0; col < n && rank < m; ++col) {
    int piv = -1;
    for (int i = rank; i < m; ++i)
      if (bm.get(i, col)) { piv = i; break; }
    if (piv < 0) continue;
    if (piv != rank)
      for (int w = 0; w < bm.words; ++w)
        std::swap(bm.row(rank)[w], bm.row(piv)[w]);
    for (int k = 0; k < m; ++k)
      if (k != rank && bm.get(k, col)) bm.xor_rows(k, rank);
    ++rank;
  }
  return rank;
}

// GF(2) matmul c = a (ma x na) * b (na x nb), all dense uint8 row-major.
void ldpc_gf2_matmul(const u8* a, const u8* b, u8* c, int ma, int na,
                     int nb) {
  BitMatrix bb(na, nb);
  for (int i = 0; i < na; ++i)
    for (int j = 0; j < nb; ++j)
      if (b[static_cast<size_t>(i) * nb + j] & 1) bb.set(i, j);
  BitMatrix acc(1, nb);
  for (int i = 0; i < ma; ++i) {
    std::memset(acc.row(0), 0, acc.words * sizeof(u64));
    const u8* arow = a + static_cast<size_t>(i) * na;
    for (int k = 0; k < na; ++k)
      if (arow[k] & 1)
        for (int w = 0; w < bb.words; ++w) acc.row(0)[w] ^= bb.row(k)[w];
    u8* crow = c + static_cast<size_t>(i) * nb;
    for (int j = 0; j < nb; ++j) crow[j] = (acc.row(0)[j >> 6] >> (j & 63)) & 1;
  }
}

// Cascaded ADMM/LP structure builder (qp_admm.h:13-102 semantics).
// Fills capacity-padded tables; pads: con_var slots == nv_cap, coefs 0,
// var_con slots == nc_cap. Returns actual n_con, or -1 if a capacity is
// exceeded. n_var_out receives the actual variable count (n + aux).
int ldpc_admm_build(const u8* h, int m, int n, int nv_cap, int nc_cap,
                    int k_cap, int* con_var, float* con_coef, float* b,
                    int* var_con, float* var_coef, float* e,
                    int* n_var_out) {
  for (int i = 0; i < nc_cap; ++i) {
    b[i] = 0.f;
    for (int s = 0; s < 3; ++s) {
      con_var[i * 3 + s] = nv_cap;
      con_coef[i * 3 + s] = 0.f;
    }
  }
  for (int v = 0; v < nv_cap; ++v) {
    e[v] = 0.f;
    for (int s = 0; s < k_cap; ++s) {
      var_con[static_cast<size_t>(v) * k_cap + s] = nc_cap;
      var_coef[static_cast<size_t>(v) * k_cap + s] = 0.f;
    }
  }
  std::vector<int> var_fill(nv_cap, 0);
  int n_con = 0;
  int pos = n;

  auto add = [&](const int* vids, const float* cfs, int cnt,
                 float rhs) -> bool {
    if (n_con >= nc_cap) return false;
    b[n_con] = rhs;
    for (int s = 0; s < cnt; ++s) {
      int vi = vids[s];
      if (vi >= nv_cap || var_fill[vi] >= k_cap) return false;
      con_var[n_con * 3 + s] = vi;
      con_coef[n_con * 3 + s] = cfs[s];
      var_con[static_cast<size_t>(vi) * k_cap + var_fill[vi]] = n_con;
      var_coef[static_cast<size_t>(vi) * k_cap + var_fill[vi]] = cfs[s];
      ++var_fill[vi];
      e[vi] += cfs[s] * cfs[s];
    }
    ++n_con;
    return true;
  };

  auto add_three = [&](int i, int j, int k) -> bool {
    const float c1[3] = {1.f, -1.f, -1.f};
    const float c2[3] = {-1.f, 1.f, -1.f};
    const float c3[3] = {-1.f, -1.f, 1.f};
    const float c4[3] = {1.f, 1.f, 1.f};
    const int v[3] = {i, j, k};
    return add(v, c1, 3, 0.f) && add(v, c2, 3, 0.f) && add(v, c3, 3, 0.f) &&
           add(v, c4, 3, 2.f);
  };

  std::vector<int> idx;
  for (int i = 0; i < m; ++i) {
    idx.clear();
    const u8* row = h + static_cast<size_t>(i) * n;
    for (int j = 0; j < n; ++j)
      if (row[j] & 1) idx.push_back(j);
    if (idx.empty()) continue;
    if (idx.size() == 1) {
      const float c1[1] = {1.f};
      if (!add(idx.data(), c1, 1, 0.f)) return -1;
      continue;
    }
    if (idx.size() == 2) {
      const float c1[2] = {1.f, -1.f};
      const float c2[2] = {-1.f, 1.f};
      if (!add(idx.data(), c1, 2, 0.f) || !add(idx.data(), c2, 2, 0.f))
        return -1;
      continue;
    }
    int last = idx[0];
    for (size_t j = 1; j + 2 < idx.size(); ++j) {
      int aux = pos++;
      if (!add_three(last, idx[j], aux)) return -1;
      last = aux;
    }
    if (!add_three(last, idx[idx.size() - 2], idx.back())) return -1;
  }
  if (pos > nv_cap) return -1;
  *n_var_out = pos;
  return n_con;
}

}  // extern "C"
