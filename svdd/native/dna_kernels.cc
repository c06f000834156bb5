// Native data-pipeline kernels: DNA tokenization, detokenization,
// k-mer counting, and CSV sequence-column parsing.
//
// The reference's data path is pure-python pandas/torch
// (reference dataloader_gosai.py:74-85 CSV -> tokens;
// oracle.py:75-85 python-dict k-mer counting). The data
// pipeline must keep up with the device without stealing host cores
// from the XLA runtime, so the hot string work lives here and is
// exposed through ctypes (svdd/native/bindings.py). Python
// fallbacks exist for every entry point.
//
// Build: see svdd/native/build.py (g++ -O3 -shared -fPIC).

#include <cstdint>
#include <cstring>
#include <cstdio>
#include <cstdlib>

extern "C" {

// ---------------------------------------------------------------------------
// Tokenize: ASCII 'A','C','G','T' (upper or lower) -> 0..3; others -> 4.
// seqs: n_seqs concatenated fixed-length strings (len each); out int32.
// ---------------------------------------------------------------------------
void dna_tokenize(const char* seqs, int64_t n_seqs, int64_t len,
                  int32_t* out) {
  static int8_t lut[256];
  static bool init = false;
  if (!init) {
    memset(lut, 4, sizeof(lut));
    lut[(unsigned char)'A'] = 0; lut[(unsigned char)'a'] = 0;
    lut[(unsigned char)'C'] = 1; lut[(unsigned char)'c'] = 1;
    lut[(unsigned char)'G'] = 2; lut[(unsigned char)'g'] = 2;
    lut[(unsigned char)'T'] = 3; lut[(unsigned char)'t'] = 3;
    init = true;
  }
  const int64_t total = n_seqs * len;
  for (int64_t i = 0; i < total; ++i) {
    out[i] = lut[(unsigned char)seqs[i]];
  }
}

// ---------------------------------------------------------------------------
// Detokenize: 0..3 -> 'A','C','G','T'; anything else -> 'N'.
// ---------------------------------------------------------------------------
void dna_detokenize(const int32_t* tokens, int64_t n_seqs, int64_t len,
                    char* out) {
  static const char kAlpha[5] = {'A', 'C', 'G', 'T', 'N'};
  const int64_t total = n_seqs * len;
  for (int64_t i = 0; i < total; ++i) {
    int32_t t = tokens[i];
    out[i] = kAlpha[(t >= 0 && t < 4) ? t : 4];
  }
}

// ---------------------------------------------------------------------------
// k-mer counting over token arrays. Counts land in a dense 4^k table
// (k <= 12); windows containing non-ACGT tokens are skipped. Returns
// the number of table slots (4^k) or -1 on invalid k.
// ---------------------------------------------------------------------------
int64_t kmer_count(const int32_t* tokens, int64_t n_seqs, int64_t len,
                   int32_t k, int64_t* table) {
  if (k < 1 || k > 12) return -1;
  const int64_t slots = ((int64_t)1) << (2 * k);
  memset(table, 0, slots * sizeof(int64_t));
  const int64_t mask = slots - 1;
  for (int64_t s = 0; s < n_seqs; ++s) {
    const int32_t* row = tokens + s * len;
    int64_t code = 0;
    int valid = 0;  // length of current run of ACGT tokens
    for (int64_t i = 0; i < len; ++i) {
      int32_t t = row[i];
      if (t < 0 || t > 3) {
        valid = 0;
        code = 0;
        continue;
      }
      code = ((code << 2) | t) & mask;
      if (++valid >= k) table[code] += 1;
    }
  }
  return slots;
}

// ---------------------------------------------------------------------------
// Positional field splitter: splits `line` on ',' IN PLACE, KEEPING
// empty tokens (strtok_r collapses consecutive delimiters, which
// silently shifted every later column index when a CSV field was
// empty — ADVICE r1). Strips a trailing \r\n. Returns the field
// count (possibly > max_fields; only the first max_fields pointers
// are stored).
// ---------------------------------------------------------------------------
static int split_fields(char* line, char** fields, int max_fields) {
  size_t len = strlen(line);
  while (len > 0 && (line[len - 1] == '\n' || line[len - 1] == '\r')) {
    line[--len] = 0;
  }
  int n = 0;
  char* p = line;
  for (;;) {
    if (n < max_fields) fields[n] = p;
    ++n;
    char* comma = strchr(p, ',');
    if (!comma) break;
    *comma = 0;
    p = comma + 1;
  }
  return n;
}

#define MAX_FIELDS 256

// ---------------------------------------------------------------------------
// CSV sequence-column extraction: find `column` in the header, then
// copy each row's field (must be exactly seq_len chars) into out.
// Returns rows parsed, or -1 on error. Minimal CSV: no quoted commas
// (true for the Gosai files); rows whose field count differs from the
// header's are skipped rather than silently misaligned.
// ---------------------------------------------------------------------------
int64_t csv_read_seq_column(const char* path, const char* column,
                            int64_t seq_len, char* out,
                            int64_t max_rows) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  char* line = nullptr;
  size_t cap = 0;
  // header
  if (getline(&line, &cap, f) <= 0) { fclose(f); free(line); return -1; }
  char* fields[MAX_FIELDS];
  int n_header = split_fields(line, fields, MAX_FIELDS);
  int col = -1;
  for (int i = 0; i < n_header && i < MAX_FIELDS; ++i) {
    if (strcmp(fields[i], column) == 0) { col = i; break; }
  }
  if (col < 0) { fclose(f); free(line); return -1; }
  int64_t rows = 0;
  while (rows < max_rows && getline(&line, &cap, f) > 0) {
    int n = split_fields(line, fields, MAX_FIELDS);
    if (n != n_header) continue;        // malformed row
    const char* tok = fields[col];
    if ((int64_t)strlen(tok) != seq_len) continue;
    memcpy(out + rows * seq_len, tok, seq_len);
    ++rows;
  }
  fclose(f);
  free(line);
  return rows;
}


// ---------------------------------------------------------------------------
// Row count (data rows, excluding header). For computing contiguous
// per-host shards before a sharded read.
// ---------------------------------------------------------------------------
int64_t csv_count_rows(const char* path) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  int64_t lines = 0;
  char buf[1 << 16];
  size_t got;
  char last = '\n';
  while ((got = fread(buf, 1, sizeof(buf), f)) > 0) {
    for (size_t i = 0; i < got; ++i) {
      if (buf[i] == '\n') ++lines;
    }
    last = buf[got - 1];
  }
  fclose(f);
  if (last != '\n') ++lines;        // unterminated final line
  return lines > 0 ? lines - 1 : 0; // minus header
}

// ---------------------------------------------------------------------------
// One-pass Gosai reader: sequence column + n_cls float columns, with a
// contiguous row range [row_offset, row_offset + max_rows) of RAW file
// lines for sharded multi-host loading (each host reads only its slice
// of the file). Bounding by raw lines consumed — not valid rows parsed
// — keeps every shard inside its raw-line plan (csv_count_rows /
// share * shard_index) and matches the pandas fallback's
// nrows-then-filter semantics; a shard containing skipped rows simply
// yields fewer rows instead of silently reading into the next host's
// shard (ADVICE r1). Fields are split positionally (empty fields
// preserved) and rows whose field count differs from the header are
// skipped, never misaligned. Returns rows parsed or -1 on error.
// ---------------------------------------------------------------------------
int64_t csv_read_gosai(const char* path, const char* seq_col,
                       const char* cls_cols, int64_t seq_len,
                       int64_t row_offset, int64_t max_rows,
                       char* seq_out, float* cls_out, int32_t n_cls) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  char* line = nullptr;
  size_t cap = 0;
  if (getline(&line, &cap, f) <= 0) { fclose(f); free(line); return -1; }

  // resolve column indices from the header (positional split)
  int seq_idx = -1;
  int cls_idx[16];
  for (int i = 0; i < n_cls && i < 16; ++i) cls_idx[i] = -1;
  char* fields[MAX_FIELDS];
  int n_header;
  {
    // split requested class names
    char want[512];
    strncpy(want, cls_cols, sizeof(want) - 1);
    want[sizeof(want) - 1] = 0;
    char* names[16];
    int n_names = 0;
    char* save0 = nullptr;
    for (char* t = strtok_r(want, ",", &save0); t && n_names < 16;
         t = strtok_r(nullptr, ",", &save0)) {
      names[n_names++] = t;
    }
    if (n_names != n_cls) { fclose(f); free(line); return -1; }
    n_header = split_fields(line, fields, MAX_FIELDS);
    for (int idx = 0; idx < n_header && idx < MAX_FIELDS; ++idx) {
      if (strcmp(fields[idx], seq_col) == 0) seq_idx = idx;
      for (int i = 0; i < n_cls; ++i) {
        if (strcmp(fields[idx], names[i]) == 0) cls_idx[i] = idx;
      }
    }
    if (seq_idx < 0) { fclose(f); free(line); return -1; }
    for (int i = 0; i < n_cls; ++i) {
      if (cls_idx[i] < 0) { fclose(f); free(line); return -1; }
    }
  }

  // skip to the shard's first raw line
  for (int64_t i = 0; i < row_offset; ++i) {
    if (getline(&line, &cap, f) <= 0) { fclose(f); free(line); return 0; }
  }

  int64_t rows = 0;
  for (int64_t consumed = 0;
       consumed < max_rows && getline(&line, &cap, f) > 0; ++consumed) {
    int n = split_fields(line, fields, MAX_FIELDS);
    if (n != n_header) continue;        // malformed row, never misread
    const char* seq_field = fields[seq_idx];
    if ((int64_t)strlen(seq_field) != seq_len) continue;
    memcpy(seq_out + rows * seq_len, seq_field, seq_len);
    for (int i = 0; i < n_cls; ++i) {
      cls_out[rows * n_cls + i] = strtof(fields[cls_idx[i]], nullptr);
    }
    ++rows;
  }
  fclose(f);
  free(line);
  return rows;
}

}  // extern "C"
