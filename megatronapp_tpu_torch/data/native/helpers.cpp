// Dataset index-building kernels (C++), ctypes ABI: the port's copy of the
// JAX package's data/native/helpers.cpp, unchanged below this header.
//
// Megatron's dataset helpers (sample-index and blending-index construction,
// backend-agnostic) with a plain C ABI so Python binds via ctypes (no
// pybind11). megatronapp_tpu_torch/data/helpers.py builds it at first use:
// g++ -O3 -shared -fPIC into build/native/, keyed on a hash of this file.

#include <cstdint>
#include <cstring>

extern "C" {

// Build the GPT sample index: for `num_samples` samples of `seq_length`+1
// tokens drawn from the document stream (documents concatenated in doc_idx
// order), record for each sample the (document-stream position, offset
// within that document) where it starts. Mirrors the semantics of the
// reference build_sample_idx (helpers.cpp:838-845 export).
//
// sizes:        token count per sequence in the underlying dataset
// doc_idx:      epoch-expanded, shuffled document order (len = num_docs_total)
// sample_idx:   out, shape [num_samples + 1, 2] int64 (doc_pos, offset)
// Returns 0 on success, -1 if the document stream is exhausted early.
int64_t build_sample_idx(const int32_t* sizes,
                         const int64_t* doc_idx,
                         int64_t doc_idx_len,
                         int64_t seq_length,
                         int64_t num_samples,
                         int64_t* sample_idx /* [(n+1)*2] */) {
    int64_t doc_pos = 0;     // position in doc_idx
    int64_t doc_offset = 0;  // token offset within current document
    sample_idx[0] = doc_pos;
    sample_idx[1] = doc_offset;
    for (int64_t i = 1; i <= num_samples; ++i) {
        int64_t remaining = seq_length;  // +1 handled by overlap convention:
        // each sample takes seq_length tokens and the next sample starts
        // seq_length later (the trailing label token overlaps the next
        // sample's first token, reference GPTDataset convention).
        while (remaining > 0) {
            if (doc_pos >= doc_idx_len) return -1;
            int64_t doc_len = sizes[doc_idx[doc_pos]] - doc_offset;
            if (doc_len > remaining) {
                doc_offset += remaining;
                remaining = 0;
            } else {
                remaining -= doc_len;
                doc_offset = 0;
                ++doc_pos;
            }
        }
        sample_idx[i * 2] = doc_pos;
        sample_idx[i * 2 + 1] = doc_offset;
    }
    return 0;
}

// Weighted blending: distribute `size` samples over `num_datasets` datasets
// proportionally to weights, tracking the running deficit (reference
// build_blending_indices): at each step pick the dataset with the largest
// (weight * i - consumed) error.
void build_blending_indices(int16_t* dataset_index,  // out [size]
                            int64_t* dataset_sample_index,  // out [size]
                            const double* weights,
                            int32_t num_datasets,
                            int64_t size) {
    int64_t* consumed = new int64_t[num_datasets];
    std::memset(consumed, 0, sizeof(int64_t) * num_datasets);
    for (int64_t i = 0; i < size; ++i) {
        double sample_count = static_cast<double>(i + 1);
        int32_t best = 0;
        double best_err = weights[0] * sample_count -
                          static_cast<double>(consumed[0]);
        for (int32_t d = 1; d < num_datasets; ++d) {
            double err = weights[d] * sample_count -
                         static_cast<double>(consumed[d]);
            if (err > best_err) {
                best_err = err;
                best = d;
            }
        }
        dataset_index[i] = static_cast<int16_t>(best);
        dataset_sample_index[i] = consumed[best];
        ++consumed[best];
    }
    delete[] consumed;
}

// --------------------------------------------------------------------------
// Sentence-span sample mapping (BERT/T5 masked datasets).
//
// Semantics of the reference build_mapping (helpers.cpp:266-561): walk
// documents (runs of sentence-level sequences), accumulate sentences until
// a target length (occasionally shortened with probability short_seq_prob)
// is reached, emit (first_sentence, end_sentence, target_len) triples,
// Fisher-Yates shuffle the map. Deterministic across the C++ and numpy
// implementations via a shared splitmix64 RNG (not the reference's
// std::mt19937 — bitwise parity with libstdc++ is not a goal; parity
// between OUR two implementations is).

static inline uint64_t splitmix64(uint64_t* state) {
    uint64_t z = (*state += 0x9E3779B97F4A7C15ULL);
    z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ULL;
    z = (z ^ (z >> 27)) * 0x94D049BB133111EBULL;
    return z ^ (z >> 31);
}

static const int32_t kLongSentenceLen = 512;

// Pass 1 (out == NULL): return the number of samples.
// Pass 2 (out != NULL, capacity = value from pass 1): fill [N,3] int64
// triples and shuffle. Returns the sample count, or -1 on bad args.
int64_t build_mapping(const int64_t* docs,       // [n_docs + 1]
                      int64_t n_docs,
                      const int32_t* sizes,      // per-sentence token counts
                      int32_t num_epochs,
                      int64_t max_num_samples,
                      int32_t max_seq_length,
                      double short_seq_prob,
                      uint64_t seed,
                      int32_t min_num_sent,
                      int64_t* out,              // NULL or [capacity * 3]
                      int64_t capacity) {
    if (num_epochs <= 0 || max_seq_length <= 1) return -1;
    uint64_t rng = seed;
    int64_t count = 0;
    for (int32_t epoch = 0; epoch < num_epochs; ++epoch) {
        if (max_num_samples > 0 && count >= max_num_samples) break;
        for (int64_t doc = 0; doc < n_docs; ++doc) {
            int64_t first = docs[doc];
            int64_t last = docs[doc + 1];
            if (last - first < min_num_sent) continue;
            bool has_long = false;
            for (int64_t s = first; s < last; ++s) {
                if (sizes[s] > kLongSentenceLen) { has_long = true; break; }
            }
            if (has_long) continue;

            int64_t start = first;
            int64_t seq_len = 0;
            int64_t num_sent = 0;
            // Target-length draw: consumes one RNG value per draw in both
            // implementations (keep in lock-step with helpers.py).
            uint64_t r = splitmix64(&rng);
            int64_t tgt = max_seq_length;
            if (short_seq_prob > 0.0 &&
                (double)(r >> 11) * (1.0 / 9007199254740992.0) <
                    short_seq_prob) {
                tgt = 2 + (int64_t)(splitmix64(&rng) %
                                    (uint64_t)(max_seq_length - 1));
            }
            for (int64_t s = first; s < last; ++s) {
                seq_len += sizes[s];
                ++num_sent;
                int64_t remain = last - s - 1;
                if ((seq_len >= tgt && remain > 1 &&
                     num_sent >= min_num_sent) || remain == 0) {
                    // Writes past `capacity` are dropped (the final epoch
                    // overshoots max_num_samples; pass 1's return is
                    // already clamped) — but the RNG stream still advances
                    // so both passes stay in lock-step.
                    if (out != NULL && count < capacity) {
                        out[count * 3] = start;
                        out[count * 3 + 1] = s + 1;
                        out[count * 3 + 2] = tgt;
                    }
                    ++count;
                    start = s + 1;
                    seq_len = 0;
                    num_sent = 0;
                    r = splitmix64(&rng);
                    tgt = max_seq_length;
                    if (short_seq_prob > 0.0 &&
                        (double)(r >> 11) * (1.0 / 9007199254740992.0) <
                            short_seq_prob) {
                        tgt = 2 + (int64_t)(splitmix64(&rng) %
                                            (uint64_t)(max_seq_length - 1));
                    }
                }
            }
        }
    }
    if (max_num_samples > 0 && count > max_num_samples)
        count = max_num_samples;
    if (out != NULL) {
        if (count > capacity) count = capacity;
        // Fisher-Yates with the shared RNG (seed + 1 stream).
        uint64_t srng = seed + 1;
        for (int64_t i = count - 1; i > 0; --i) {
            int64_t j = (int64_t)(splitmix64(&srng) % (uint64_t)(i + 1));
            for (int k = 0; k < 3; ++k) {
                int64_t t = out[i * 3 + k];
                out[i * 3 + k] = out[j * 3 + k];
                out[j * 3 + k] = t;
            }
        }
    }
    return count;
}

// Exhaustive blending: draw EXACTLY sizes[d] samples from dataset d (the
// reference build_exhaustive_blending_indices, helpers.cpp:21-74 semantics):
// weights derive from sizes, the largest-deficit dataset wins each step,
// and a dataset leaves the candidate set once exhausted. Total output
// length = sum(sizes). Deterministic, no RNG.
void build_exhaustive_blending_indices(
        int16_t* dataset_index,        // out [sum(sizes)]
        int64_t* dataset_sample_index, // out [sum(sizes)]
        const int64_t* sizes,
        int32_t num_datasets) {
    int64_t total = 0;
    for (int32_t d = 0; d < num_datasets; ++d) total += sizes[d];
    int64_t* consumed = new int64_t[num_datasets];
    bool* spent = new bool[num_datasets];
    double* weights = new double[num_datasets];
    for (int32_t d = 0; d < num_datasets; ++d) {
        consumed[d] = 0;
        spent[d] = (sizes[d] == 0);
        weights[d] = total > 0
            ? static_cast<double>(sizes[d]) / static_cast<double>(total)
            : 0.0;
    }
    for (int64_t i = 0; i < total; ++i) {
        double step = i > 0 ? static_cast<double>(i) : 1.0;
        int32_t best = -1;
        double best_err = 0.0;
        for (int32_t d = 0; d < num_datasets; ++d) {
            if (spent[d]) continue;
            double err = weights[d] * step -
                         static_cast<double>(consumed[d]);
            if (best < 0 || err > best_err) {
                best_err = err;
                best = d;
            }
        }
        dataset_index[i] = static_cast<int16_t>(best);
        dataset_sample_index[i] = consumed[best];
        if (++consumed[best] >= sizes[best]) spent[best] = true;
    }
    delete[] weights;
    delete[] spent;
    delete[] consumed;
}

// Block sample mapping for ICT/REALM-style retrieval pretraining
// (reference build_blocks_mapping_impl, helpers.cpp:564-804 semantics):
// walk each document's sentences, close a block when the accumulated
// length reaches max_seq_length - title_len(doc) (leaving at least
// min_num_sent sentences for the next block), and record
// (first_sentence, end_sentence, doc, block_id) quadruples; block_id is
// unique within an epoch. Fisher-Yates shuffle at the end.
//
// Two-pass contract like build_mapping above: out == NULL returns the
// count; second call fills [capacity, 4] int64.
int64_t build_blocks_mapping(const int64_t* docs,      // [n_docs + 1]
                             int64_t n_docs,
                             const int32_t* sizes,     // per-sentence tokens
                             const int32_t* title_sizes,  // [n_docs]
                             int32_t num_epochs,
                             int64_t max_num_samples,
                             int32_t max_seq_length,
                             uint64_t seed,
                             int32_t min_num_sent,  // 1 = one-sent blocks
                             int64_t* out,          // NULL or [capacity*4]
                             int64_t capacity) {
    if (num_epochs <= 0 || max_seq_length <= 1 || min_num_sent < 1)
        return -1;
    int64_t count = 0;
    for (int32_t epoch = 0; epoch < num_epochs; ++epoch) {
        if (max_num_samples > 0 && count >= max_num_samples) break;
        int64_t block_id = 0;
        for (int64_t doc = 0; doc < n_docs; ++doc) {
            int64_t first = docs[doc];
            int64_t last = docs[doc + 1];
            int64_t remain = last - first;
            if (remain < min_num_sent) continue;
            bool has_long = false;
            for (int64_t s = first; s < last; ++s) {
                if (sizes[s] > kLongSentenceLen) { has_long = true; break; }
            }
            if (has_long) continue;
            int64_t tgt = max_seq_length - title_sizes[doc];
            int64_t start = first;
            int64_t seq_len = 0;
            int64_t num_sent = 0;
            for (int64_t s = first; s < last; ++s) {
                seq_len += sizes[s];
                ++num_sent;
                --remain;
                if ((seq_len >= tgt && remain >= min_num_sent &&
                     num_sent >= min_num_sent) || remain == 0) {
                    if (out != NULL && count < capacity) {
                        out[count * 4] = start;
                        out[count * 4 + 1] = s + 1;
                        out[count * 4 + 2] = doc;
                        out[count * 4 + 3] = block_id;
                    }
                    ++count;
                    ++block_id;
                    start = s + 1;
                    seq_len = 0;
                    num_sent = 0;
                }
            }
        }
    }
    if (max_num_samples > 0 && count > max_num_samples)
        count = max_num_samples;
    if (out != NULL) {
        if (count > capacity) count = capacity;
        uint64_t srng = seed + 1;
        for (int64_t i = count - 1; i > 0; --i) {
            int64_t j = (int64_t)(splitmix64(&srng) % (uint64_t)(i + 1));
            for (int k = 0; k < 4; ++k) {
                int64_t t = out[i * 4 + k];
                out[i * 4 + k] = out[j * 4 + k];
                out[j * 4 + k] = t;
            }
        }
    }
    return count;
}

}  // extern "C"
