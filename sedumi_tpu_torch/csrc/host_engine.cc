// sedumi_tpu native host engine: sparse-symbolic analysis for the
// factorization planner.
//
// Reference analogs (re-designed, not translated):
//   ordmmd.c      -> sed_amd        (approximate minimum degree, quotient
//                                    graph with supervariables + element
//                                    absorption; same role as Liu's MMD)
//   symfct.c      -> sed_etree / sed_postorder / sed_colcounts /
//                    sed_symbolic  (elimination tree, supernodal partition,
//                                    symbolic Cholesky pattern)
//   cholsplit.c   -> sed_supernodes(maxwidth) panel splitting
//   (new scope)   -> sed_levels    (elimination-tree level schedule for
//                                    batched TPU execution)
//
// All graphs are 0-based CSC upper-or-full symmetric patterns with int32
// indices and int64 column pointers.  Everything is plain C ABI for ctypes.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

using std::int32_t;
using std::int64_t;

extern "C" {

// ---------------------------------------------------------------------------
// Elimination tree of A (pattern of A must be symmetric; uses upper part).
// Liu's algorithm with path compression.  parent[j] = -1 for roots.
// ---------------------------------------------------------------------------
int sed_etree(int32_t n, const int64_t* colptr, const int32_t* rowind,
              int32_t* parent) {
  std::vector<int32_t> ancestor(n, -1);
  for (int32_t j = 0; j < n; ++j) {
    parent[j] = -1;
    for (int64_t p = colptr[j]; p < colptr[j + 1]; ++p) {
      int32_t i = rowind[p];
      if (i >= j) continue;  // use strictly-upper entries (i < j)
      // walk from i to the root, compressing
      while (ancestor[i] != -1 && ancestor[i] != j) {
        int32_t next = ancestor[i];
        ancestor[i] = j;
        if (parent[i] == -1) parent[i] = next;
        i = next;
      }
      if (ancestor[i] == -1) {
        ancestor[i] = j;
        if (parent[i] == -1 && i != j) parent[i] = j;
      }
    }
  }
  return 0;
}

// ---------------------------------------------------------------------------
// Postorder of the elimination forest.  post[k] = k-th node in postorder.
// ---------------------------------------------------------------------------
int sed_postorder(int32_t n, const int32_t* parent, int32_t* post) {
  std::vector<int32_t> head(n, -1), next(n, -1);
  // children lists, built in reverse so traversal is in increasing order
  for (int32_t j = n - 1; j >= 0; --j) {
    int32_t p = parent[j];
    if (p >= 0) {
      next[j] = head[p];
      head[p] = j;
    }
  }
  int32_t k = 0;
  std::vector<int32_t> stack;
  stack.reserve(n);
  for (int32_t root = 0; root < n; ++root) {
    if (parent[root] != -1) continue;
    stack.push_back(root);
    while (!stack.empty()) {
      int32_t j = stack.back();
      int32_t c = head[j];
      if (c != -1) {
        head[j] = next[c];  // defer j until children done
        stack.push_back(c);
      } else {
        stack.pop_back();
        post[k++] = j;
      }
    }
  }
  return (k == n) ? 0 : 1;
}

// ---------------------------------------------------------------------------
// Column counts of the Cholesky factor (including the diagonal) via plain
// row-subtree traversal: for each row i, walk up the etree from each entry
// until the previously-visited part; O(|L|) total.
// ---------------------------------------------------------------------------
int sed_colcounts(int32_t n, const int64_t* colptr, const int32_t* rowind,
                  const int32_t* parent, int32_t* counts) {
  std::vector<int32_t> mark(n, -1);
  for (int32_t j = 0; j < n; ++j) counts[j] = 1;  // diagonal
  for (int32_t i = 0; i < n; ++i) {
    mark[i] = i;
    for (int64_t p = colptr[i]; p < colptr[i + 1]; ++p) {
      int32_t j = rowind[p];
      if (j > i) continue;  // strictly-lower-or-diag entries of row i: use j<i
      int32_t t = j;
      while (t != -1 && mark[t] != i) {
        counts[t] += 1;  // L(i, t) exists
        mark[t] = i;
        t = parent[t];
      }
    }
  }
  return 0;
}

// ---------------------------------------------------------------------------
// Fundamental supernodes, split to a maximum panel width.
// snode[j] = supernode id of column j; ids contiguous in column order.
// Fundamental: col j joins j-1's supernode iff parent[j-1] == j and
// count[j] == count[j-1] - 1 (and width < maxwidth).
// ---------------------------------------------------------------------------
int sed_supernodes(int32_t n, const int32_t* parent, const int32_t* counts,
                   int32_t maxwidth, int32_t* snode, int32_t* nsuper_out) {
  if (n == 0) { *nsuper_out = 0; return 0; }
  int32_t ns = 0;
  int32_t width = 1;
  snode[0] = 0;
  for (int32_t j = 1; j < n; ++j) {
    bool fuse = (parent[j - 1] == j) && (counts[j] == counts[j - 1] - 1) &&
                (maxwidth <= 0 || width < maxwidth);
    if (fuse) {
      snode[j] = ns;
      ++width;
    } else {
      snode[j] = ++ns;
      width = 1;
    }
  }
  *nsuper_out = ns + 1;
  return 0;
}

// ---------------------------------------------------------------------------
// Elimination-tree level schedule: level[j] = max depth from any leaf
// (leaves = level 0); columns at the same level are independent given all
// lower levels are done.  Used to batch TPU panel factorizations.
// ---------------------------------------------------------------------------
int sed_levels(int32_t n, const int32_t* parent, int32_t* level,
               int32_t* nlevels_out) {
  // process in natural order: parent[j] > j always for etrees
  int32_t maxl = -1;
  for (int32_t j = 0; j < n; ++j) level[j] = 0;
  for (int32_t j = 0; j < n; ++j) {
    int32_t p = parent[j];
    if (p >= 0 && level[p] < level[j] + 1) level[p] = level[j] + 1;
    if (level[j] > maxl) maxl = level[j];
  }
  *nlevels_out = maxl + 1;
  return 0;
}

// ---------------------------------------------------------------------------
// Symbolic Cholesky: full row pattern of L (lower, including diagonal).
// Two-pass: count, then fill.  Caller allocates lcolptr[n+1]; first call
// with lrowind == nullptr to get sizes, then with the buffer.
// Pattern rule: struct(L_j) = struct(A_j, below diag) U union of
// struct(L_c)\{c} over children c of j in the etree.
// ---------------------------------------------------------------------------
int64_t sed_symbolic(int32_t n, const int64_t* colptr, const int32_t* rowind,
                     const int32_t* parent, int64_t* lcolptr,
                     int32_t* lrowind) {
  // For each column j collect pattern via row-subtree walk transposed:
  // entry L(i,j) exists iff j is on the path from some k (A(i,k) != 0,
  // k <= i) to the root, j <= i.  Equivalent: for each row i, the columns
  // j with L(i,j)!=0 are exactly the nodes visited by the row-subtree
  // walk used in sed_colcounts.  We emit them per row, then convert to CSC.
  std::vector<int32_t> mark(n, -1);
  std::vector<int64_t> cnt(n, 0);
  // pass 1: counts per column
  for (int32_t i = 0; i < n; ++i) {
    mark[i] = i;
    cnt[i] += 1;  // diagonal
    for (int64_t p = colptr[i]; p < colptr[i + 1]; ++p) {
      int32_t j = rowind[p];
      if (j > i) continue;
      int32_t t = j;
      while (t != -1 && mark[t] != i) {
        cnt[t] += 1;
        mark[t] = i;
        t = parent[t];
      }
    }
  }
  int64_t nnz = 0;
  for (int32_t j = 0; j < n; ++j) nnz += cnt[j];
  lcolptr[0] = 0;
  for (int32_t j = 0; j < n; ++j) lcolptr[j + 1] = lcolptr[j] + cnt[j];
  if (lrowind == nullptr) return nnz;

  // pass 2: fill (row indices ascend automatically since we scan i in order)
  std::fill(mark.begin(), mark.end(), -1);
  std::vector<int64_t> head(n);
  for (int32_t j = 0; j < n; ++j) head[j] = lcolptr[j];
  for (int32_t i = 0; i < n; ++i) {
    mark[i] = i;
    lrowind[head[i]++] = i;  // diagonal
    for (int64_t p = colptr[i]; p < colptr[i + 1]; ++p) {
      int32_t j = rowind[p];
      if (j > i) continue;
      int32_t t = j;
      while (t != -1 && mark[t] != i) {
        lrowind[head[t]++] = i;  // L(i,t)
        mark[t] = i;
        t = parent[t];
      }
    }
  }
  return nnz;
}

// ---------------------------------------------------------------------------
// Approximate minimum-degree ordering (quotient graph, element absorption,
// approximate external degrees).  Self-contained implementation of the
// published AMD algorithm family; fills the role of the reference's MMD
// (ordmmd.c) in producing a fill-reducing permutation.
// perm[k] = original index of the k-th pivot (new -> old).
// ---------------------------------------------------------------------------
int sed_amd(int32_t n, const int64_t* colptr, const int32_t* rowind,
            int32_t* perm) {
  if (n <= 0) return 0;

  // --- build deduplicated full adjacency (no self loops) ---
  std::vector<int64_t> cnt(n, 0);
  for (int32_t j = 0; j < n; ++j)
    for (int64_t p = colptr[j]; p < colptr[j + 1]; ++p) {
      int32_t i = rowind[p];
      if (i != j) { ++cnt[i]; ++cnt[j]; }
    }
  std::vector<int64_t> ptr(n + 1, 0);
  for (int32_t j = 0; j < n; ++j) ptr[j + 1] = ptr[j] + cnt[j];
  std::vector<int32_t> adj0(ptr[n]);
  {
    std::vector<int64_t> fill = ptr;
    for (int32_t j = 0; j < n; ++j)
      for (int64_t p = colptr[j]; p < colptr[j + 1]; ++p) {
        int32_t i = rowind[p];
        if (i == j) continue;
        adj0[fill[i]++] = j;
        adj0[fill[j]++] = i;
      }
  }

  // arena with append-only growth; slices per node
  int64_t arena_end = 0;
  std::vector<int32_t> mem;
  mem.reserve(ptr[n] * 2 + 64);
  std::vector<int64_t> pstart(n), plen(n);
  for (int32_t j = 0; j < n; ++j) {
    int32_t* b = adj0.data() + ptr[j];
    int64_t len = ptr[j + 1] - ptr[j];
    std::sort(b, b + len);
    len = std::unique(b, b + len) - b;
    pstart[j] = arena_end;
    plen[j] = len;
    mem.insert(mem.end(), b, b + len);
    arena_end += len;
  }

  enum : int8_t { VAR = 0, ELEM = 1, DEAD = 2 };
  std::vector<int8_t> kind(n, VAR);
  std::vector<int64_t> degree(n);
  for (int32_t j = 0; j < n; ++j) degree[j] = plen[j];
  std::vector<int32_t> order(n, -1);
  std::vector<int64_t> w(n, -1);
  int64_t wflag = 0;

  // bucketed degree lists (degrees clamped to n)
  std::vector<int32_t> dhead(n + 1, -1), dnext(n, -1), dprev(n, -1);
  auto bucket = [&](int64_t d) { return (int32_t)std::min<int64_t>(d, n); };
  auto deg_insert = [&](int32_t v) {
    int32_t d = bucket(degree[v]);
    dnext[v] = dhead[d];
    dprev[v] = -1;
    if (dhead[d] != -1) dprev[dhead[d]] = v;
    dhead[d] = v;
  };
  auto deg_remove = [&](int32_t v, int64_t dold) {
    int32_t d = bucket(dold);
    if (dprev[v] != -1) dnext[dprev[v]] = dnext[v];
    else if (dhead[d] == v) dhead[d] = dnext[v];
    if (dnext[v] != -1) dprev[dnext[v]] = dprev[v];
    dnext[v] = dprev[v] = -1;
  };
  for (int32_t v = 0; v < n; ++v) deg_insert(v);

  auto append_slice = [&](int32_t node, const int32_t* data, int64_t len) {
    pstart[node] = arena_end;
    plen[node] = len;
    mem.insert(mem.end(), data, data + len);
    arena_end += len;
  };

  std::vector<int32_t> lpat, tmp;
  int32_t k = 0;
  int64_t mindeg = 0;
  while (k < n) {
    while (mindeg <= n && dhead[bucket(mindeg)] == -1) ++mindeg;
    if (mindeg > n) break;
    int32_t piv = dhead[bucket(mindeg)];
    deg_remove(piv, degree[piv]);

    // element pattern = live var neighbors  U  vars of element neighbors
    lpat.clear();
    ++wflag;
    w[piv] = wflag;
    for (int64_t p = pstart[piv]; p < pstart[piv] + plen[piv]; ++p) {
      int32_t u = mem[p];
      if (kind[u] == VAR) {
        if (w[u] != wflag) { w[u] = wflag; lpat.push_back(u); }
      } else if (kind[u] == ELEM) {
        for (int64_t q = pstart[u]; q < pstart[u] + plen[u]; ++q) {
          int32_t v2 = mem[q];
          if (kind[v2] == VAR && w[v2] != wflag) {
            w[v2] = wflag;
            lpat.push_back(v2);
          }
        }
        kind[u] = DEAD;  // absorbed into the new element
      }
    }

    order[piv] = k++;
    kind[piv] = ELEM;
    append_slice(piv, lpat.data(), (int64_t)lpat.size());

    // update each pattern variable: compact adjacency, ensure piv listed,
    // recompute approximate external degree
    for (int32_t v : lpat) {
      tmp.clear();
      tmp.push_back(piv);
      for (int64_t p = pstart[v]; p < pstart[v] + plen[v]; ++p) {
        int32_t u = mem[p];
        if (u == piv || u == v || kind[u] == DEAD) continue;
        tmp.push_back(u);
      }
      append_slice(v, tmp.data(), (int64_t)tmp.size());

      ++wflag;
      w[v] = wflag;
      int64_t d = 0;
      for (int32_t u : tmp) {
        if (kind[u] == VAR) {
          if (w[u] != wflag) { w[u] = wflag; ++d; }
        } else {  // ELEM
          for (int64_t q = pstart[u]; q < pstart[u] + plen[u]; ++q) {
            int32_t v2 = mem[q];
            if (kind[v2] == VAR && w[v2] != wflag) { w[v2] = wflag; ++d; }
          }
        }
      }
      int64_t dold = degree[v];
      degree[v] = d;
      deg_remove(v, dold);
      deg_insert(v);
      if (d < mindeg) mindeg = d;
    }

    // periodic arena compaction: copy live slices to a fresh arena
    if (arena_end > (int64_t)16 * (ptr[n] + n + 1)) {
      std::vector<int32_t> mem2;
      mem2.reserve(ptr[n] + n);
      int64_t pos = 0;
      for (int32_t j2 = 0; j2 < n; ++j2) {
        if (kind[j2] == DEAD) { plen[j2] = 0; pstart[j2] = 0; continue; }
        mem2.insert(mem2.end(), mem.begin() + pstart[j2],
                    mem.begin() + pstart[j2] + plen[j2]);
        pstart[j2] = pos;
        pos += plen[j2];
      }
      mem.swap(mem2);
      arena_end = pos;
    }
  }

  // emit permutation; append any nodes never ordered (isolated, etc.)
  {
    std::vector<std::pair<int32_t, int32_t>> ord;
    ord.reserve(n);
    for (int32_t j = 0; j < n; ++j)
      if (order[j] >= 0) ord.push_back({order[j], j});
    std::sort(ord.begin(), ord.end());
    int32_t pos = 0;
    std::vector<int8_t> used(n, 0);
    for (auto& pr : ord) { perm[pos++] = pr.second; used[pr.second] = 1; }
    for (int32_t j = 0; j < n; ++j)
      if (!used[j]) perm[pos++] = j;
  }
  return 0;
}

}  // extern "C"
