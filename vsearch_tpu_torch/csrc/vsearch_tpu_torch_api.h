/* vsearch_tpu_torch C-ABI embedding shim.
 *
 * The reference ships an embeddable static library with a C++ session
 * protocol (reference: src/vsearch_api.h:60-124, LIBRARY_API.md):
 * session_begin -> Database/Dbindex -> per-subsystem session handles ->
 * per-query calls -> teardown -> session_end.  The PyTorch/CUDA port's
 * session API is Python (vsearch_tpu_torch/api.py); this header is the
 * thin C-callable rendering of the same protocol for embedders that are
 * not Python programs.  The shim (capi.c) hosts a CPython interpreter
 * in-process, which imports torch and loads the port's CUDA kernels
 * (the .cu sources of csrc/, built with nvcc at first use), and forwards
 * each call to the corresponding vsearch_tpu_torch.api object; results
 * marshal into plain C structs.
 *
 * The declarations, names and the vstpu_hit_t layout are those of the
 * JAX package's shim (native/vsearch_tpu_api.h): an embedder moves from
 * one to the other by relinking, without a change to its source.
 *
 * Protocol (mirrors vsearch_api.h's initialization sequence):
 *
 *   1. vstpu_api_init()                  - start the interpreter (once);
 *                                          when the shim starts it, the
 *                                          calling thread gives the GIL
 *                                          back before returning
 *   2. p = vstpu_params_new()            - fresh library-default config
 *   3. vstpu_params_set_num/str(p, ...)  - override options ("id", 0.97)
 *   4. vstpu_session_begin(p)            - process-wide session guard; it
 *                                          selects the device: cuda, or
 *                                          the CPU's plain versions of
 *                                          the kernels when the
 *                                          environment sets
 *                                          VSEARCH_TPU_TORCH_DEVICE=cpu;
 *                                          -1 without a card and without
 *                                          that request, and -1 while
 *                                          another session is active
 *   5. h = vstpu_search_open(p, dbpath)  - load+mask+index the database,
 *                                          allocate the search session
 *   6. vstpu_search_single(h, ...)       - per-query calls (thread-safe:
 *                                          the shim takes the GIL per
 *                                          call, and one search at a time
 *                                          runs on a handle)
 *   7. vstpu_search_close(h)
 *   8. vstpu_session_end()
 *   9. vstpu_params_free(p); vstpu_api_finalize()
 *
 * vstpu_api_finalize leaves the interpreter running (a CUDA context does
 * not survive a second interpreter start): sequential sessions in one
 * process begin again at step 1 or 2.  The interpreter finds torch and
 * this package through PYTHONPATH.
 *
 * Every function returns 0 / a valid handle on success and -1 / NULL on
 * failure (the Python exception is printed to stderr).
 */

#ifndef VSEARCH_TPU_TORCH_API_H
#define VSEARCH_TPU_TORCH_API_H

#include <stddef.h>

#ifdef __cplusplus
extern "C" {
#endif

typedef struct {
    long   target;          /* DB sequence ordinal */
    double id;              /* identity percentage (opt_iddef definition) */
    long   matches;
    long   mismatches;
    long   gaps;            /* internal gaps */
    long   alignment_length;
    long   query_length;
    long   target_length;
    int    strand;          /* 0 = plus, 1 = minus */
    char   target_label[256];
    char   cigar[4096];
} vstpu_hit_t;

/* runtime lifecycle */
int  vstpu_api_init(void);          /* returns api version (>=0) or -1 */
void vstpu_api_finalize(void);

/* Parameters (the reference's ~200-field struct; option names match the
 * CLI long options without the leading dashes) */
void *vstpu_params_new(void);
int   vstpu_params_set_num(void *params, const char *opt, double value);
int   vstpu_params_set_str(void *params, const char *opt,
                           const char *value);
void  vstpu_params_free(void *params);

/* process-wide session guard (vsearch_session_begin/end) */
int vstpu_session_begin(void *params);
int vstpu_session_end(void);

/* search session (search_session_alloc/init/single/cleanup/free) */
void *vstpu_search_open(void *params, const char *db_path);
/* aligns one query; fills up to cap hits, returns the hit count or -1 */
int   vstpu_search_single(void *handle, const char *header,
                          const char *sequence, vstpu_hit_t *out,
                          int cap);
void  vstpu_search_close(void *handle);

/* DUST low-complexity masking of one sequence (mask.cpp dust_single);
 * writes the masked sequence (NUL-terminated) into out, returns its
 * length or -1 (cap must exceed strlen(sequence)) */
int vstpu_dust_single(const char *sequence, char *out, int cap);

#ifdef __cplusplus
}
#endif

#endif /* VSEARCH_TPU_TORCH_API_H */
