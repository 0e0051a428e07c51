// sgrace_host: native host-runtime for the sgracex1_tpu framework.
//
// The equivalent of the reference's C++ host layer (main_float.cpp:138-824 —
// CSR/dense text loaders, dense<->CSR converters) plus the hot host-side
// preprocessing this design adds on top: the GCN symmetric-normalization
// pass, RCM reordering and the nnz-balanced row partitioner. The compute
// path stays on the device (JAX/XLA); this library is the part of the
// framework that the reference also keeps native: parsing, conversion,
// scheduling.
//
// C ABI, consumed from Python via ctypes (sgracex1_tpu/runtime/native.py).
// All functions are handle-based: build -> query sizes -> copy into
// caller-allocated numpy buffers -> free.

#include <algorithm>
#include <cctype>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <numeric>
#include <string>
#include <vector>

namespace {

// ---------------------------------------------------------------- text input

// Read a whole file into a string (binary, single read).
bool read_file(const char* path, std::string& out) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  std::fseek(f, 0, SEEK_END);
  long n = std::ftell(f);
  if (n < 0) {
    std::fclose(f);
    return false;
  }
  std::fseek(f, 0, SEEK_SET);
  out.resize(static_cast<size_t>(n));
  size_t got = n ? std::fread(&out[0], 1, static_cast<size_t>(n), f) : 0;
  std::fclose(f);
  out.resize(got);
  return true;
}

// Split the buffer into non-empty lines (views into the buffer).
struct LineView {
  const char* p;
  size_t n;
};

std::vector<LineView> split_lines(const std::string& buf) {
  std::vector<LineView> lines;
  const char* p = buf.data();
  const char* end = p + buf.size();
  while (p < end) {
    const char* nl = static_cast<const char*>(memchr(p, '\n', end - p));
    const char* e = nl ? nl : end;
    const char* a = p;
    while (a < e && std::isspace(static_cast<unsigned char>(*a))) ++a;
    const char* b = e;
    while (b > a && std::isspace(static_cast<unsigned char>(b[-1]))) --b;
    if (b > a) lines.push_back({a, static_cast<size_t>(b - a)});
    p = nl ? nl + 1 : end;
  }
  return lines;
}

// Parse comma/space-separated numbers from one line.
template <typename T, typename Conv>
void parse_tokens(const LineView& ln, Conv conv, std::vector<T>& out) {
  const char* p = ln.p;
  const char* end = ln.p + ln.n;
  while (p < end) {
    while (p < end &&
           (*p == ',' || std::isspace(static_cast<unsigned char>(*p))))
      ++p;
    if (p >= end) break;
    char* next = nullptr;
    out.push_back(conv(p, &next));
    if (next == p) break;  // malformed token: stop rather than loop forever
    p = next;
  }
}

void parse_i64(const LineView& ln, std::vector<int64_t>& out) {
  parse_tokens<int64_t>(
      ln, [](const char* p, char** q) { return std::strtoll(p, q, 10); }, out);
}

void parse_f32(const LineView& ln, std::vector<float>& out) {
  parse_tokens<float>(
      ln, [](const char* p, char** q) { return std::strtof(p, q); }, out);
}

}  // namespace

// ------------------------------------------------------------------ CSR text

// 3-line CSR text (main_float.cpp:415-659): rowPtr / colIdx / values.
// Values line optional or truncated; missing values default to 1.0 (the
// molecule notebook's binary matrices ship without values).
struct SgCsr {
  std::vector<int64_t> rowptr;
  std::vector<int32_t> cols;
  std::vector<float> vals;
};

extern "C" {

SgCsr* sg_csr_load(const char* path) {
  std::string buf;
  if (!read_file(path, buf)) return nullptr;
  auto lines = split_lines(buf);
  if (lines.size() < 2) return nullptr;

  auto* h = new SgCsr();
  parse_i64(lines[0], h->rowptr);
  if (h->rowptr.empty()) {
    delete h;
    return nullptr;
  }
  std::vector<int64_t> cols64;
  parse_i64(lines[1], cols64);
  size_t nnz = static_cast<size_t>(h->rowptr.back());

  h->cols.reserve(nnz);
  for (size_t i = 0; i < cols64.size() && i < nnz; ++i)
    h->cols.push_back(static_cast<int32_t>(cols64[i]));
  if (h->cols.size() < nnz) {
    delete h;
    return nullptr;  // colIdx shorter than rowPtr claims
  }

  if (lines.size() >= 3) parse_f32(lines[2], h->vals);
  h->vals.resize(nnz, 1.0f);  // pad (or create) with ones
  return h;
}

int64_t sg_csr_nrows(SgCsr* h) {
  return static_cast<int64_t>(h->rowptr.size()) - 1;
}
int64_t sg_csr_nnz(SgCsr* h) { return h->rowptr.back(); }

void sg_csr_copy(SgCsr* h, int64_t* rowptr, int32_t* cols, float* vals) {
  std::memcpy(rowptr, h->rowptr.data(), h->rowptr.size() * sizeof(int64_t));
  std::memcpy(cols, h->cols.data(), h->cols.size() * sizeof(int32_t));
  std::memcpy(vals, h->vals.data(), h->vals.size() * sizeof(float));
}

void sg_csr_free(SgCsr* h) { delete h; }

// ---------------------------------------------------------------- dense text

// One comma-separated row per line (main_float.cpp:138-319). Ragged rows are
// zero-padded to the widest row, matching the Python loader.
struct SgDense {
  int64_t rows = 0, cols = 0;
  std::vector<float> data;  // row-major [rows, cols]
};

SgDense* sg_dense_load(const char* path) {
  std::string buf;
  if (!read_file(path, buf)) return nullptr;
  auto lines = split_lines(buf);
  auto* h = new SgDense();
  std::vector<std::vector<float>> rows;
  rows.reserve(lines.size());
  size_t width = 0;
  for (auto& ln : lines) {
    rows.emplace_back();
    parse_f32(ln, rows.back());
    width = std::max(width, rows.back().size());
  }
  h->rows = static_cast<int64_t>(rows.size());
  h->cols = static_cast<int64_t>(width);
  h->data.assign(static_cast<size_t>(h->rows * h->cols), 0.0f);
  for (size_t i = 0; i < rows.size(); ++i)
    std::memcpy(&h->data[i * width], rows[i].data(),
                rows[i].size() * sizeof(float));
  return h;
}

int64_t sg_dense_rows(SgDense* h) { return h->rows; }
int64_t sg_dense_cols(SgDense* h) { return h->cols; }
void sg_dense_copy(SgDense* h, float* out) {
  std::memcpy(out, h->data.data(), h->data.size() * sizeof(float));
}
void sg_dense_free(SgDense* h) { delete h; }

// ------------------------------------------------------------- COO utilities

// Stable lexsort of COO edges by (row, col); writes the permutation.
// Mirrors np.lexsort((cols, rows)).
void sg_coo_sort(int64_t nnz, const int32_t* rows, const int32_t* cols,
                 int64_t* perm) {
  for (int64_t i = 0; i < nnz; ++i) perm[i] = i;
  std::stable_sort(perm, perm + nnz, [&](int64_t a, int64_t b) {
    if (rows[a] != rows[b]) return rows[a] < rows[b];
    return cols[a] < cols[b];
  });
}

// ------------------------------------------------ GCN symmetric normalization

// sym_norm2 (sgrace.py:18-51): add a self-loop (weight `fill`) to every node
// lacking one, sort edges by (row, col), then w'(i,j) = d_i^-1/2 w d_j^-1/2
// with d = per-row weight sum (double accumulation, matching numpy float64).
struct SgSym {
  std::vector<int64_t> row, col;
  std::vector<float> w;
};

SgSym* sg_sym_norm(int64_t n, int64_t e, const int64_t* row_in,
                   const int64_t* col_in, const float* w_in, float fill) {
  auto* h = new SgSym();
  std::vector<uint8_t> has_loop(static_cast<size_t>(n), 0);
  for (int64_t i = 0; i < e; ++i)
    if (row_in[i] == col_in[i] && row_in[i] >= 0 && row_in[i] < n)
      has_loop[static_cast<size_t>(row_in[i])] = 1;
  int64_t missing = 0;
  for (int64_t v = 0; v < n; ++v) missing += !has_loop[v];

  int64_t total = e + missing;
  h->row.resize(total);
  h->col.resize(total);
  h->w.resize(total);
  std::memcpy(h->row.data(), row_in, e * sizeof(int64_t));
  std::memcpy(h->col.data(), col_in, e * sizeof(int64_t));
  if (w_in)
    std::memcpy(h->w.data(), w_in, e * sizeof(float));
  else
    std::fill(h->w.begin(), h->w.begin() + e, 1.0f);
  int64_t k = e;
  for (int64_t v = 0; v < n; ++v)
    if (!has_loop[v]) {
      h->row[k] = v;
      h->col[k] = v;
      h->w[k] = fill;
      ++k;
    }

  std::vector<int64_t> perm(static_cast<size_t>(total));
  std::iota(perm.begin(), perm.end(), 0);
  std::stable_sort(perm.begin(), perm.end(), [&](int64_t a, int64_t b) {
    if (h->row[a] != h->row[b]) return h->row[a] < h->row[b];
    return h->col[a] < h->col[b];
  });
  std::vector<int64_t> r2(total), c2(total);
  std::vector<float> w2(total);
  for (int64_t i = 0; i < total; ++i) {
    r2[i] = h->row[perm[i]];
    c2[i] = h->col[perm[i]];
    w2[i] = h->w[perm[i]];
  }
  h->row.swap(r2);
  h->col.swap(c2);
  h->w.swap(w2);

  std::vector<double> deg(static_cast<size_t>(n), 0.0);
  for (int64_t i = 0; i < total; ++i)
    deg[static_cast<size_t>(h->row[i])] += h->w[i];
  std::vector<double> dis(static_cast<size_t>(n), 0.0);
  for (int64_t v = 0; v < n; ++v) {
    double d = deg[static_cast<size_t>(v)];
    double s = (d > 0.0) ? 1.0 / std::sqrt(d) : 0.0;
    dis[static_cast<size_t>(v)] = std::isfinite(s) ? s : 0.0;
  }
  for (int64_t i = 0; i < total; ++i)
    h->w[i] = static_cast<float>(dis[static_cast<size_t>(h->row[i])] *
                                 static_cast<double>(h->w[i]) *
                                 dis[static_cast<size_t>(h->col[i])]);
  return h;
}

int64_t sg_sym_nnz(SgSym* h) { return static_cast<int64_t>(h->w.size()); }
void sg_sym_copy(SgSym* h, int64_t* row, int64_t* col, float* w) {
  std::memcpy(row, h->row.data(), h->row.size() * sizeof(int64_t));
  std::memcpy(col, h->col.data(), h->col.size() * sizeof(int64_t));
  std::memcpy(w, h->w.data(), h->w.size() * sizeof(float));
}
void sg_sym_free(SgSym* h) { delete h; }

// ----------------------------------------------------------- RCM reordering

// Reverse Cuthill-McKee over the symmetrized pattern of a COO matrix.
// Produces a bandwidth-reducing node permutation: perm[new_id] = old_id.
// Used to give the edge path's gathers locality — the analogue of the
// reference's assumption that its datasets arrive in a cache-friendly node
// order.
void sg_rcm_order(int64_t n, int64_t nnz, const int32_t* rows,
                  const int32_t* cols, int32_t* perm_out) {
  // symmetrize: adjacency list over pattern of A + A^T (dedup not needed
  // for BFS correctness; duplicates only cost a visited check)
  std::vector<int64_t> deg(static_cast<size_t>(n), 0);
  for (int64_t i = 0; i < nnz; ++i) {
    if (rows[i] == cols[i]) continue;
    ++deg[static_cast<size_t>(rows[i])];
    ++deg[static_cast<size_t>(cols[i])];
  }
  std::vector<int64_t> ptr(static_cast<size_t>(n) + 1, 0);
  for (int64_t v = 0; v < n; ++v) ptr[v + 1] = ptr[v] + deg[v];
  std::vector<int32_t> adj(static_cast<size_t>(ptr[n]));
  std::vector<int64_t> fill(ptr.begin(), ptr.end() - 1);
  for (int64_t i = 0; i < nnz; ++i) {
    if (rows[i] == cols[i]) continue;
    adj[static_cast<size_t>(fill[rows[i]]++)] = cols[i];
    adj[static_cast<size_t>(fill[cols[i]]++)] = rows[i];
  }

  std::vector<uint8_t> visited(static_cast<size_t>(n), 0);
  std::vector<int32_t> order;
  order.reserve(static_cast<size_t>(n));
  std::vector<int32_t> queue;
  std::vector<int32_t> nbrs;

  // nodes by ascending degree for component-start selection
  std::vector<int32_t> by_deg(static_cast<size_t>(n));
  std::iota(by_deg.begin(), by_deg.end(), 0);
  std::stable_sort(by_deg.begin(), by_deg.end(),
                   [&](int32_t a, int32_t b) { return deg[a] < deg[b]; });

  for (int32_t s : by_deg) {
    if (visited[static_cast<size_t>(s)]) continue;
    visited[static_cast<size_t>(s)] = 1;
    size_t head = order.size();
    order.push_back(s);
    while (head < order.size()) {
      int32_t v = order[head++];
      nbrs.clear();
      for (int64_t k = ptr[v]; k < ptr[v + 1]; ++k) {
        int32_t u = adj[static_cast<size_t>(k)];
        if (!visited[static_cast<size_t>(u)]) {
          visited[static_cast<size_t>(u)] = 1;
          nbrs.push_back(u);
        }
      }
      std::stable_sort(nbrs.begin(), nbrs.end(), [&](int32_t a, int32_t b) {
        return deg[a] < deg[b];
      });
      order.insert(order.end(), nbrs.begin(), nbrs.end());
    }
  }
  // reverse (the "R" in RCM)
  for (int64_t i = 0; i < n; ++i)
    perm_out[i] = order[static_cast<size_t>(n - 1 - i)];
}

// ------------------------------------------------------ balanced row partition
// Contiguous row ranges with approximately equal nnz (greedy prefix cuts at
// nnz_total/parts boundaries). The nnz-balanced alternative to the equal-node
// split of parallel/partition.py, for degree-skewed graphs.
void sg_partition_balance(int64_t n_rows, const int64_t* rowptr,
                          int32_t n_parts, int64_t* bounds /* n_parts+1 */) {
  int64_t total = rowptr[n_rows];
  bounds[0] = 0;
  int64_t r = 0;
  for (int32_t p = 1; p < n_parts; ++p) {
    int64_t target = (total * p) / n_parts;
    while (r < n_rows && rowptr[r] < target) ++r;
    bounds[p] = r;
  }
  bounds[n_parts] = n_rows;
}

}  // extern "C"
