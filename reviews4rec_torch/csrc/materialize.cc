// Native record materializer: the host data-loader hot path of
// reviews4rec_torch (`data/native.py` builds this file with g++ -O3
// -fopenmp into build/native/ at first use and calls it through ctypes).
//
// It assembles fixed-shape, leakage-removed record tensors from the
// ragged review store, one OpenMP thread per block of examples, byte for
// byte what the numpy materializer `ReviewDataset._python_text` writes.
//
// Layout contract (all int32 unless noted, C-contiguous; mirrors
// reviews4rec_torch/data/corpus.py::ReviewDataset._flat):
//   tokens[]             flat token stream of every review
//   rev_off[R+1]         review r occupies tokens[rev_off[r]:rev_off[r+1]]
//                        (int64)
//   u_revs[], u_off[U+1] review ids of user u: u_revs[u_off[u]:u_off[u+1]]
//                        (u_off int64)
//   u_other[]            aligned item ids (u_to_i)
//   i_revs[], i_off[I+1] likewise per item, i_other = users (i_to_u)
//
// Per example x: user[x], item[x], ui_idx[x]/iu_idx[x] = position of the
// pair's own review in the user's/item's list (-1 for eval splits:
// nothing is held out), this_rev[x] = review id for this_doc (-1 ->
// zeros).
//
// Doc layout: rows = 1 -> the reviews concatenated into one doc of
// `words` tokens, truncated; rows > 1 -> one review a row, [rows, words].
// Neighbor lists pad to `slots` with the sentinel ids.

#include <cstdint>
#include <cstring>
#include <algorithm>

#ifdef _OPENMP
#include <omp.h>
#endif

extern "C" {

static inline void emit_docs(
    const int32_t* tokens, const int64_t* rev_off,
    const int32_t* revs, int32_t n_revs, int32_t skip_idx,
    int32_t rows, int32_t words, int32_t* out /* [rows*words] */) {
  std::memset(out, 0, sizeof(int32_t) * (size_t)rows * words);
  if (rows == 1) {
    // concatenate-and-truncate
    int32_t at = 0;
    for (int32_t j = 0; j < n_revs && at < words; ++j) {
      if (j == skip_idx) continue;
      const int32_t r = revs[j];
      const int64_t s = rev_off[r], e = rev_off[r + 1];
      const int32_t n = (int32_t)std::min<int64_t>(e - s, words - at);
      std::memcpy(out + at, tokens + s, sizeof(int32_t) * n);
      at += n;
    }
  } else {
    int32_t row = 0;
    for (int32_t j = 0; j < n_revs && row < rows; ++j) {
      if (j == skip_idx) continue;
      const int32_t r = revs[j];
      const int64_t s = rev_off[r], e = rev_off[r + 1];
      const int32_t n = (int32_t)std::min<int64_t>(e - s, words);
      std::memcpy(out + (size_t)row * words, tokens + s,
                  sizeof(int32_t) * n);
      ++row;
    }
  }
}

static inline void emit_neighbors(
    const int32_t* other, int32_t n, int32_t skip_idx,
    int32_t pad_id, int32_t slots, int32_t* out) {
  int32_t at = 0;
  for (int32_t j = 0; j < n && at < slots; ++j) {
    if (j == skip_idx) continue;
    out[at++] = other[j];
  }
  for (; at < slots; ++at) out[at] = pad_id;
}

// Returns 0 on success.
int materialize_records(
    // review store
    const int32_t* tokens, const int64_t* rev_off,
    const int32_t* u_revs, const int64_t* u_off, const int32_t* u_other,
    const int32_t* i_revs, const int64_t* i_off, const int32_t* i_other,
    // examples
    int64_t n_examples,
    const int32_t* user, const int32_t* item,
    const int32_t* ui_idx, const int32_t* iu_idx,
    const int32_t* this_rev,
    // layout
    int32_t rows, int32_t words, int32_t slots,
    int32_t user_pad_id, int32_t item_pad_id,
    // outputs [n, rows*words] x3, [n, slots] x2
    int32_t* user_doc, int32_t* item_doc, int32_t* this_doc,
    int32_t* users_who_gave, int32_t* items_reviewed) {
  const size_t doc_sz = (size_t)rows * words;
#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic, 256)
#endif
  for (int64_t x = 0; x < n_examples; ++x) {
    const int32_t u = user[x], it = item[x];
    const int32_t n_ur = (int32_t)(u_off[u + 1] - u_off[u]);
    const int32_t n_ir = (int32_t)(i_off[it + 1] - i_off[it]);
    const int32_t* ur = u_revs + u_off[u];
    const int32_t* ir = i_revs + i_off[it];

    emit_docs(tokens, rev_off, ur, n_ur, ui_idx[x], rows, words,
              user_doc + x * doc_sz);
    emit_docs(tokens, rev_off, ir, n_ir, iu_idx[x], rows, words,
              item_doc + x * doc_sz);

    // this_doc: single review (or zeros)
    std::memset(this_doc + x * doc_sz, 0, sizeof(int32_t) * doc_sz);
    if (this_rev[x] >= 0) {
      const int32_t r = this_rev[x];
      const int64_t s = rev_off[r], e = rev_off[r + 1];
      const int32_t n = (int32_t)std::min<int64_t>(e - s, words);
      std::memcpy(this_doc + x * doc_sz, tokens + s, sizeof(int32_t) * n);
    }

    emit_neighbors(u_other + u_off[u], n_ur, ui_idx[x], item_pad_id,
                   slots, items_reviewed + x * slots);
    emit_neighbors(i_other + i_off[it], n_ir, iu_idx[x], user_pad_id,
                   slots, users_who_gave + x * slots);
  }
  return 0;
}

int materialize_num_threads() {
#ifdef _OPENMP
  return omp_get_max_threads();
#else
  return 1;
#endif
}

}  // extern "C"
