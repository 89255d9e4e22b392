// Native host-side data engine of daspeech_torch (a copy of
// native/daspeech_native.cpp, built apart by daspeech_torch/data/native.py).
//
// The reference's Cython batching (fairseq/fairseq/data/data_utils_fast.pyx)
// plus a padded-collation copy: the per-epoch O(N) batching walk and the
// per-batch feature memcpy run in C++ behind a plain C interface (ctypes).
//
// Build: g++ -O3 -shared -fPIC daspeech_native.cpp -o libdaspeech_native.so

#include <cstdint>
#include <cstring>
#include <algorithm>

extern "C" {

// fairseq batch_by_size semantics (data_utils_fast.pyx:25-120):
// walk indices in order, open a new batch when adding the next sample would
// exceed max_tokens (with num_tokens = batch_len * max_len_in_batch) or
// max_sentences; batch sizes are rounded down to a multiple of bsz_mult
// when possible.
//
// indices/num_tokens: arrays of length n.
// out_batch_ids: per-sample batch id (length n).
// returns: number of batches.
int64_t batch_by_size(
    const int64_t* indices,
    const int64_t* num_tokens,       // tokens per sample, same order
    int64_t n,
    int64_t max_tokens,
    int64_t max_sentences,
    int64_t bsz_mult,
    int64_t* out_batch_ids)
{
    if (n == 0) return 0;
    int64_t batch = 0;
    int64_t batch_start = 0;
    int64_t batch_max_len = 0;

    auto is_full = [&](int64_t count, int64_t max_len) {
        if (count == 0) return false;
        if (max_sentences > 0 && count > max_sentences) return true;
        if (max_tokens > 0 && count * max_len > max_tokens) return true;
        return false;
    };

    for (int64_t i = 0; i < n; ++i) {
        int64_t tok = num_tokens[indices ? indices[i] : i];
        int64_t cand_max = std::max(batch_max_len, tok);
        int64_t count = i - batch_start + 1;
        if (is_full(count, cand_max)) {
            // close the previous batch, rounding to bsz_mult where possible
            int64_t size = i - batch_start;
            if (size == 0) {
                // single sample exceeding max_tokens: keep it in the open
                // batch so it lands alone in its own batch (fairseq
                // data_utils_fast.pyx keeps oversized sentences solo rather
                // than emitting an empty batch)
                batch_max_len = cand_max;
                continue;
            }
            int64_t mod = size % bsz_mult;
            int64_t keep = (size > bsz_mult && mod != 0) ? size - mod : size;
            if (keep <= 0) keep = size;
            for (int64_t j = batch_start; j < batch_start + keep; ++j)
                out_batch_ids[j] = batch;
            ++batch;
            batch_start += keep;
            // recompute max over the carried-over tail
            batch_max_len = 0;
            for (int64_t j = batch_start; j <= i; ++j) {
                int64_t t = num_tokens[indices ? indices[j] : j];
                batch_max_len = std::max(batch_max_len, t);
            }
        } else {
            batch_max_len = cand_max;
        }
    }
    for (int64_t j = batch_start; j < n; ++j)
        out_batch_ids[j] = batch;
    return batch + 1;
}

// Pack variable-length float feature matrices into a zero-initialized
// padded [B, T_cap, F] buffer. srcs: concatenated row-major sources;
// offsets[i]..offsets[i+1] delimit sample i (in floats).
void pack_frames(
    const float* srcs,
    const int64_t* offsets,          // length B+1, in float elements
    int64_t B,
    int64_t feat_dim,
    int64_t t_cap,
    float* out)                      // [B, t_cap, feat_dim], pre-zeroed
{
    for (int64_t b = 0; b < B; ++b) {
        int64_t n_floats = offsets[b + 1] - offsets[b];
        int64_t rows = n_floats / feat_dim;
        if (rows > t_cap) rows = t_cap;
        std::memcpy(out + b * t_cap * feat_dim,
                    srcs + offsets[b],
                    sizeof(float) * rows * feat_dim);
    }
}

// Pad int32 token sequences into [B, t_cap] filled with pad_value.
void pack_tokens(
    const int32_t* srcs,
    const int64_t* offsets,          // length B+1, in elements
    int64_t B,
    int64_t t_cap,
    int32_t pad_value,
    int32_t* out)                    // [B, t_cap]
{
    for (int64_t b = 0; b < B; ++b) {
        int64_t n = offsets[b + 1] - offsets[b];
        if (n > t_cap) n = t_cap;
        int32_t* row = out + b * t_cap;
        std::memcpy(row, srcs + offsets[b], sizeof(int32_t) * n);
        for (int64_t j = n; j < t_cap; ++j) row[j] = pad_value;
    }
}

}  // extern "C"
