// Native oracle machinery: set-partition enumeration, canonicalization,
// and lexicographic ranking of restricted-growth strings (RGS).
//
// Reference analog: the reference keeps its hot host-side bookkeeping in
// C++ (common:include/microscopes/common/group_manager.hpp et al.).  In
// the JAX rebuild the *inference* hot path lives on-device (XLA/Pallas),
// so the host-side native layer serves the piece that actually runs hot
// on the host: the exact-enumeration test oracle
// (common:microscopes/common/testutil.py, permutation_iter /
// permutation_canonical), where Bell(n)-sized enumerations and
// 100k-sample canonicalization dominate test wall-time at n >= 8.
//
// Exposed C ABI (ctypes; see common_tpu/native/__init__.py):
//   ct_bell(n)                        Bell number (n <= 25)
//   ct_enumerate(n, out)              all canonical RGS, lex order [B, n]
//   ct_canonicalize(in, s, n, out)    first-occurrence relabel, batched
//   ct_rank(in, s, n, out)            lex rank of canonical RGS vectors
//
// Build: g++ -O3 -shared -fPIC (no dependencies).

#include <cstdint>

namespace {

// D[i][j] = number of RGS completions for positions i..n-1 given that the
// maximum label used so far is j.  D[n][j] = 1; D[i][j] = (j+1)*D[i+1][j]
// + D[i+1][j+1].  Also yields Bell(n) = D[1][0] (position 0 is fixed 0).
void completion_table(int n, uint64_t* d /* (n+1) x (n+2) */) {
    const int w = n + 2;
    for (int j = 0; j < w; ++j) d[n * w + j] = 1;
    for (int i = n - 1; i >= 0; --i) {
        for (int j = w - 2; j >= 0; --j) {
            d[i * w + j] =
                (uint64_t)(j + 1) * d[(i + 1) * w + j] + d[(i + 1) * w + j + 1];
        }
    }
}

}  // namespace

extern "C" {

uint64_t ct_bell(int n) {
    if (n <= 0 || n > 25) return 0;
    const int w = n + 2;
    uint64_t* d = new uint64_t[(n + 1) * w];
    completion_table(n, d);
    uint64_t b = d[1 * w + 0];  // completions after fixing a[0] = 0
    if (n == 1) b = 1;
    delete[] d;
    return b;
}

// Fill out[B * n] with every canonical RGS of length n in lexicographic
// order (matching the Python permutation_iter).  Returns the count.
uint64_t ct_enumerate(int n, int32_t* out) {
    if (n <= 0 || n > 20) return 0;
    int32_t a[32];
    int32_t maxg[32];  // max label among a[0..i]
    a[0] = 0;
    maxg[0] = 0;
    uint64_t count = 0;
    int i = 1;
    if (n == 1) {
        out[0] = 0;
        return 1;
    }
    a[1] = -1;  // about to try next value at position 1
    while (i >= 1) {
        int32_t next = a[i] + 1;
        if (next > maxg[i - 1] + 1) {  // exhausted: backtrack
            --i;
            continue;
        }
        a[i] = next;
        maxg[i] = next > maxg[i - 1] ? next : maxg[i - 1];
        if (i == n - 1) {  // complete vector: emit, stay at this position
            for (int t = 0; t < n; ++t) out[count * n + t] = a[t];
            ++count;
        } else {
            ++i;
            a[i] = -1;
        }
    }
    return count;
}

// Canonicalize s assignment vectors of length n (first-occurrence
// relabel).  Labels may be arbitrary int32 >= 0 and < 2^31; uses a
// per-row linear scan with an open-addressed map sized for n labels.
void ct_canonicalize(const int32_t* in, int64_t s, int n, int32_t* out) {
    // per-row scratch: old-label list (at most n distinct labels)
    int32_t* olds = new int32_t[n];
    for (int64_t r = 0; r < s; ++r) {
        const int32_t* row = in + r * n;
        int32_t* dst = out + r * n;
        int used = 0;
        for (int t = 0; t < n; ++t) {
            int32_t lab = row[t];
            int found = -1;
            for (int u = 0; u < used; ++u) {
                if (olds[u] == lab) { found = u; break; }
            }
            if (found < 0) {
                found = used;
                olds[used++] = lab;
            }
            dst[t] = found;
        }
    }
    delete[] olds;
}

// Lex rank (within ct_enumerate order) of canonical RGS vectors.
void ct_rank(const int32_t* in, int64_t s, int n, int64_t* out) {
    const int w = n + 2;
    uint64_t* d = new uint64_t[(n + 1) * w];
    completion_table(n, d);
    for (int64_t r = 0; r < s; ++r) {
        const int32_t* row = in + r * n;
        uint64_t rank = 0;
        int maxg = 0;
        for (int i = 1; i < n; ++i) {
            int32_t ai = row[i];
            // smaller digits c in [0, ai): each leaves max = max(maxg, c)
            for (int32_t c = 0; c < ai; ++c) {
                int m2 = c > maxg ? c : maxg;
                rank += d[(i + 1) * w + m2];
            }
            if (ai > maxg) maxg = ai;
        }
        out[r] = (int64_t)rank;
    }
    delete[] d;
}

}  // extern "C"
