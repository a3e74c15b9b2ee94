/* Demo embedder of the PyTorch/CUDA port's C-ABI shim
 * (vsearch_tpu_torch_api.h): loads a FASTA database, opens a search
 * session, aligns every query from a second FASTA, one
 * vstpu_search_single call a query, and prints one TSV row per hit:
 *
 *     query  target_label  id  matches  mismatches  gaps
 *
 *     capi_demo db.fasta queries.fasta id [option=value ...]
 *
 * The three arguments, the parameters they set and the row are those of
 * the JAX package's demo (native/capi_demo.c).  Each further argument
 * overrides one option of the Parameters (a number through
 * vstpu_params_set_num, else a string), e.g. wordlength=8: a default
 * Parameters resolves its minimum word matches before its word length,
 * which leaves every k-mer of a query required.  Runs on cuda unless the
 * environment sets VSEARCH_TPU_TORCH_DEVICE=cpu. */

#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#include "vsearch_tpu_torch_api.h"

#define MAXSEQ (1 << 20)
#define MAXHITS 16

/* minimal single-line-or-wrapped FASTA reader */
static int next_record(FILE *fh, char *header, size_t hcap,
                       char *seq, size_t scap)
{
    static char line[65536];
    long pos;
    if (fgets(line, sizeof line, fh) == NULL)
        return 0;
    if (line[0] != '>')
        return 0;
    line[strcspn(line, "\r\n")] = '\0';
    snprintf(header, hcap, "%s", line + 1);
    seq[0] = '\0';
    size_t n = 0;
    for (;;) {
        pos = ftell(fh);
        if (fgets(line, sizeof line, fh) == NULL)
            break;
        if (line[0] == '>') {
            fseek(fh, pos, SEEK_SET);
            break;
        }
        line[strcspn(line, "\r\n")] = '\0';
        size_t l = strlen(line);
        if (n + l + 1 < scap) {
            memcpy(seq + n, line, l + 1);
            n += l;
        }
    }
    return 1;
}

/* option=value arguments onto the Parameters; -1 on a malformed one */
static int set_options(void *params, int argc, char **argv)
{
    for (int a = 0; a < argc; a++) {
        char *eq = strchr(argv[a], '=');
        if (eq == NULL) {
            fprintf(stderr, "not option=value: %s\n", argv[a]);
            return -1;
        }
        *eq = '\0';
        char *end;
        double v = strtod(eq + 1, &end);
        int rc = (*end == '\0' && end != eq + 1)
            ? vstpu_params_set_num(params, argv[a], v)
            : vstpu_params_set_str(params, argv[a], eq + 1);
        if (rc != 0)
            return -1;
    }
    return 0;
}

int main(int argc, char **argv)
{
    if (argc < 4) {
        fprintf(stderr, "usage: %s db.fasta queries.fasta id "
                "[option=value ...]\n", argv[0]);
        return 2;
    }
    if (vstpu_api_init() < 0)
        return 1;
    void *params = vstpu_params_new();
    if (params == NULL)
        return 1;
    vstpu_params_set_num(params, "id", atof(argv[3]));
    vstpu_params_set_num(params, "minseqlength", 1);
    if (set_options(params, argc - 4, argv + 4) != 0)
        return 1;
    if (vstpu_session_begin(params) != 0)
        return 1;
    void *search = vstpu_search_open(params, argv[1]);
    if (search == NULL)
        return 1;

    FILE *fh = fopen(argv[2], "r");
    if (fh == NULL) {
        perror(argv[2]);
        return 1;
    }
    char header[4096];
    char *seq = malloc(MAXSEQ);
    vstpu_hit_t hits[MAXHITS];
    while (next_record(fh, header, sizeof header, seq, MAXSEQ)) {
        int n = vstpu_search_single(search, header, seq, hits, MAXHITS);
        if (n < 0)
            return 1;
        for (int i = 0; i < n; i++)
            printf("%s\t%s\t%.1f\t%ld\t%ld\t%ld\n", header,
                   hits[i].target_label, hits[i].id, hits[i].matches,
                   hits[i].mismatches, hits[i].gaps);
    }
    fclose(fh);
    free(seq);
    vstpu_search_close(search);
    vstpu_session_end();
    vstpu_params_free(params);
    vstpu_api_finalize();
    return 0;
}
