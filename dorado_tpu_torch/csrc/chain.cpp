// Colinear anchor chaining (minimap2-style DP) for the from-scratch mapper.
//
// The recurrence is inherently sequential (score[i] depends on finalised
// score[j], j < i), which makes it a poor fit for numpy; in C++ the
// bounded-lookback loop runs at memory speed. Scoring mirrors
// alignment/mapper.py::_chain (simplified minimap2 chain score: capped match
// minus affine-ish gap cost).

#include <cmath>
#include <cstdint>

extern "C" {

// q/r: anchor positions sorted by (r, q); n anchors.
// out_chain receives indices (into the sorted order) of the best chain,
// in increasing order; returns the chain length. *out_score = best score.
int dt_chain(const int64_t* q,
             const int64_t* r,
             int n,
             int k,
             int max_gap,
             int lookback,
             int32_t* out_chain,
             double* out_score) {
    if (n <= 0) {
        *out_score = 0.0;
        return 0;
    }
    double* score = new double[n];
    int32_t* parent = new int32_t[n];
    for (int i = 0; i < n; ++i) {
        score[i] = static_cast<double>(k);
        parent[i] = -1;
        const int lo = (i - lookback) > 0 ? (i - lookback) : 0;
        for (int j = i - 1; j >= lo; --j) {
            const int64_t dq = q[i] - q[j];
            const int64_t dr = r[i] - r[j];
            if (dq <= 0 || dr <= 0 || dq > max_gap || dr > max_gap) {
                continue;
            }
            const int64_t gap = dq > dr ? dq - dr : dr - dq;
            const int64_t m0 = dq < dr ? dq : dr;
            const double match = static_cast<double>(m0 < k ? m0 : k);
            const double gap_cost =
                    gap ? 0.01 * k * static_cast<double>(gap) + 0.5 * std::log2(double(gap) + 1.0)
                        : 0.0;
            const double s = score[j] + match - gap_cost;
            if (s > score[i]) {
                score[i] = s;
                parent[i] = j;
            }
        }
    }
    int best = 0;
    for (int i = 1; i < n; ++i) {
        if (score[i] > score[best]) {
            best = i;
        }
    }
    *out_score = score[best];
    int len = 0;
    for (int i = best; i != -1; i = parent[i]) {
        ++len;
    }
    int pos = len;
    for (int i = best; i != -1; i = parent[i]) {
        out_chain[--pos] = i;
    }
    delete[] score;
    delete[] parent;
    return len;
}

}  // extern "C"
