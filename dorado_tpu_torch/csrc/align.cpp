// Unit-cost edit-distance alignment with traceback, host code of the port's
// read splitter (dorado_tpu_torch/splitter), barcode classifier, adapter and
// primer finders (dorado_tpu_torch/demux) and poly(A) anchors
// (dorado_tpu_torch/polytail), covering the modes the reference gets from
// edlib:
//   mode 0 (NW):  global  - gaps at all ends cost 1
//   mode 1 (HW):  infix   - gaps at target start AND end are free
//   mode 2 (SHW): prefix  - gap at target end is free
//
// A copy of the JAX package's dt_align (dorado_tpu/native/align.cpp), its DP
// and traceback unchanged: ties go to up, then left, then diagonal (strict <
// in that order), and the traceback follows those moves, which decides the
// t_start a split point comes from.
//
// Op codes match edlib's conventions:
//   0 = match, 1 = query-consumed-only (insertion to target),
//   2 = target-consumed-only (deletion from target), 3 = mismatch.
//
// Algorithm: banded dynamic programming over a diagonal band of radius `band`
// around the query/target diagonal, with 2-bit traceback moves stored per
// band cell. The caller (dorado_tpu_torch/utils/align.py) retries with a
// wider band when the returned distance implies the band may have clipped
// the optimum.
//
// Built by g++ at first use and called through ctypes, which releases the
// interpreter lock for the call.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <limits>
#include <vector>

namespace {
constexpr int32_t kInf = std::numeric_limits<int32_t>::max() / 4;

enum Move : uint8_t { kDiag = 0, kUp = 1, kLeft = 2, kNone = 3 };
}  // namespace

extern "C" {

// Returns 0 on success, -1 if the ops buffer is too small, -2 on bad args.
// ops are emitted query-start -> query-end. For HW mode, *t_start/*t_end give
// the matched target span (end exclusive).
int dt_align(const uint8_t* query,
             int qlen,
             const uint8_t* target,
             int tlen,
             int mode,
             int band,
             int32_t* out_dist,
             int32_t* t_start,
             int32_t* t_end,
             uint8_t* ops,
             int ops_cap,
             int32_t* ops_len,
             int32_t* band_hit,
             const uint8_t* eq_table) {  // optional 256x256 extra-equality table
    if (qlen < 0 || tlen < 0 || mode < 0 || mode > 2) {
        return -2;
    }
    if (band <= 0) {
        band = std::max(32, std::abs(qlen - tlen) + 32);
    }
    const bool free_t_start = (mode == 1);
    const bool free_t_end = (mode == 1 || mode == 2);

    // Band: for query row i, target columns j in [center(i)-band, center(i)+band]
    // where center(i) tracks the main diagonal scaled by length ratio.
    const int width = 2 * band + 1;
    auto center = [&](int i) {
        return qlen ? static_cast<int>(static_cast<int64_t>(i) * tlen / std::max(1, qlen)) : 0;
    };

    std::vector<int32_t> prev(width, kInf), cur(width, kInf);
    std::vector<uint8_t> moves(static_cast<size_t>(qlen + 1) * width, kNone);
    *band_hit = 0;

    // Row 0: distance to reach (0, j).
    {
        const int c0 = center(0);
        for (int w = 0; w < width; ++w) {
            const int j = c0 - band + w;
            if (j < 0 || j > tlen) {
                continue;
            }
            prev[w] = free_t_start ? 0 : j;
            moves[w] = (j == 0) ? kNone : kLeft;
        }
    }

    for (int i = 1; i <= qlen; ++i) {
        const int ci = center(i);
        const int cp = center(i - 1);
        std::fill(cur.begin(), cur.end(), kInf);
        uint8_t* mrow = &moves[static_cast<size_t>(i) * width];
        for (int w = 0; w < width; ++w) {
            const int j = ci - band + w;
            if (j < 0 || j > tlen) {
                continue;
            }
            int32_t best = kInf;
            uint8_t mv = kNone;
            // up: (i-1, j) -> consume query base (gap in target)
            {
                const int wp = j - (cp - band);
                if (wp >= 0 && wp < width && prev[wp] < kInf) {
                    const int32_t v = prev[wp] + 1;
                    if (v < best) {
                        best = v;
                        mv = kUp;
                    }
                }
            }
            if (j > 0) {
                // left: (i, j-1) -> consume target base (gap in query)
                const int wl = w - 1;
                if (wl >= 0 && cur[wl] < kInf) {
                    const int32_t v = cur[wl] + 1;
                    if (v < best) {
                        best = v;
                        mv = kLeft;
                    }
                }
                // diag: (i-1, j-1)
                const int wd = (j - 1) - (cp - band);
                if (wd >= 0 && wd < width && prev[wd] < kInf) {
                    const uint8_t qc = query[i - 1], tc = target[j - 1];
                    const bool eq = qc == tc || (eq_table && eq_table[qc * 256 + tc]);
                    const int32_t v = prev[wd] + (eq ? 0 : 1);
                    if (v < best) {
                        best = v;
                        mv = kDiag;
                    }
                }
            }
            cur[w] = best;
            mrow[w] = mv;
        }
        std::swap(prev, cur);
    }

    // Find the end point in the last row.
    int best_j = tlen;
    int32_t best_d = kInf;
    const int cq = center(qlen);
    if (free_t_end) {
        for (int w = 0; w < width; ++w) {
            const int j = cq - band + w;
            if (j < 0 || j > tlen) {
                continue;
            }
            if (prev[w] < best_d) {
                best_d = prev[w];
                best_j = j;
            }
        }
    } else {
        const int w = tlen - (cq - band);
        if (w >= 0 && w < width) {
            best_d = prev[w];
        }
    }
    if (best_d >= kInf) {
        *band_hit = 1;
        *out_dist = -1;
        *ops_len = 0;
        return 0;
    }
    // A path of cost d deviates at most d (+1 for diagonal interpolation)
    // from the band center, so d < band proves the band did not clip the
    // optimum. (HW's free end gaps don't count toward d, so always accept
    // only when provable; callers widen otherwise.)
    if (best_d + 1 >= band) {
        *band_hit = 1;
    }

    // Traceback.
    std::vector<uint8_t> rev_ops;
    rev_ops.reserve(qlen + tlen);
    int i = qlen;
    int j = best_j;
    // In HW mode the target prefix is free: stop at the query start.
    while (i > 0 || (j > 0 && !free_t_start)) {
        const int w = j - (center(i) - band);
        if (w < 0 || w >= width) {
            *band_hit = 1;
            break;
        }
        const uint8_t mv = moves[static_cast<size_t>(i) * width + w];
        if (mv == kNone) {
            break;  // reached a free start
        }
        if (mv == kDiag) {
            const uint8_t qc = query[i - 1], tc = target[j - 1];
            const bool eq = qc == tc || (eq_table && eq_table[qc * 256 + tc]);
            rev_ops.push_back(eq ? 0 : 3);
            --i;
            --j;
        } else if (mv == kUp) {
            rev_ops.push_back(1);
            --i;
        } else {
            rev_ops.push_back(2);
            --j;
        }
    }

    if (static_cast<int>(rev_ops.size()) > ops_cap) {
        return -1;
    }
    for (size_t k = 0; k < rev_ops.size(); ++k) {
        ops[k] = rev_ops[rev_ops.size() - 1 - k];
    }
    *ops_len = static_cast<int32_t>(rev_ops.size());
    *out_dist = best_d;
    *t_start = j;
    *t_end = best_j;
    return 0;
}

}  // extern "C"
