/* A C embedder of the C-ABI shim whose searches run in two threads: the
 * main thread initializes the interpreter, opens the session and then
 * joins two pthreads that each search every other query.  The rows are
 * printed in query order, as capi_demo prints them:
 *
 *     capi_threads db.fasta queries.fasta id [option=value ...]
 *
 * With the shim's main thread still holding the GIL after
 * vstpu_api_init, each worker would wait for it for ever. */

#include <pthread.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#include "vsearch_tpu_torch_api.h"

#define MAXQ 4096
#define MAXHITS 16
#define NTHREADS 2

static char *heads[MAXQ], *seqs[MAXQ], *rows[MAXQ];
static int nq;
static void *search;
static int failed;

static char *slurp(const char *path)
{
    FILE *fh = fopen(path, "rb");
    if (fh == NULL)
        return NULL;
    fseek(fh, 0, SEEK_END);
    long n = ftell(fh);
    fseek(fh, 0, SEEK_SET);
    char *buf = malloc(n + 1);
    if (fread(buf, 1, n, fh) != (size_t) n) {
        fclose(fh);
        return NULL;
    }
    buf[n] = '\0';
    fclose(fh);
    return buf;
}

/* two-line FASTA records: header line, sequence line */
static int read_queries(const char *path)
{
    char *buf = slurp(path);
    if (buf == NULL)
        return -1;
    for (char *line = strtok(buf, "\n"); line; line = strtok(NULL, "\n")) {
        if (line[0] == '>') {
            if (nq == MAXQ)
                return -1;
            heads[nq] = line + 1;
            seqs[nq++] = "";
        } else if (nq > 0) {
            seqs[nq - 1] = line;
        }
    }
    return 0;
}

static void *worker(void *arg)
{
    long t = (long) arg;
    vstpu_hit_t hits[MAXHITS];
    for (int q = (int) t; q < nq; q += NTHREADS) {
        int n = vstpu_search_single(search, heads[q], seqs[q], hits,
                                    MAXHITS);
        if (n < 0) {
            failed = 1;
            return NULL;
        }
        size_t cap = 64 + (size_t) n * (strlen(heads[q]) + 320);
        char *out = malloc(cap);
        size_t len = 0;
        out[0] = '\0';
        for (int i = 0; i < n; i++)
            len += snprintf(out + len, cap - len,
                            "%s\t%s\t%.1f\t%ld\t%ld\t%ld\n", heads[q],
                            hits[i].target_label, hits[i].id,
                            hits[i].matches, hits[i].mismatches,
                            hits[i].gaps);
        rows[q] = out;
    }
    return NULL;
}

int main(int argc, char **argv)
{
    if (argc < 4) {
        fprintf(stderr, "usage: %s db.fasta queries.fasta id "
                "[option=value ...]\n", argv[0]);
        return 2;
    }
    if (read_queries(argv[2]) != 0 || vstpu_api_init() < 0)
        return 1;
    void *params = vstpu_params_new();
    if (params == NULL)
        return 1;
    vstpu_params_set_num(params, "id", atof(argv[3]));
    vstpu_params_set_num(params, "minseqlength", 1);
    for (int a = 4; a < argc; a++) {
        char *eq = strchr(argv[a], '=');
        if (eq == NULL)
            return 2;
        *eq = '\0';
        if (vstpu_params_set_num(params, argv[a], atof(eq + 1)) != 0)
            return 1;
    }
    if (vstpu_session_begin(params) != 0)
        return 1;
    search = vstpu_search_open(params, argv[1]);
    if (search == NULL)
        return 1;
    pthread_t th[NTHREADS];
    for (long t = 0; t < NTHREADS; t++)
        pthread_create(&th[t], NULL, worker, (void *) t);
    for (int t = 0; t < NTHREADS; t++)
        pthread_join(th[t], NULL);
    if (failed)
        return 1;
    for (int q = 0; q < nq; q++)
        fputs(rows[q], stdout);
    vstpu_search_close(search);
    vstpu_session_end();
    vstpu_params_free(params);
    vstpu_api_finalize();
    return 0;
}
