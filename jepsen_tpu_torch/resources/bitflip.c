/* bitflip: flip random bits in a file, in place.
 *
 * Usage: bitflip spray <percent> <file>
 *
 * Flips each bit of the file independently with probability
 * percent/100 (so "spray 0.1 f" corrupts ~1/1000 of f's bits). The
 * capability mirror of the Go tool the reference downloads
 * (jepsen/src/jepsen/nemesis.clj:550-599, aybabtme/bitflip); built
 * from source on DB nodes instead of fetching a release binary.
 */
#define _POSIX_C_SOURCE 200809L
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <time.h>

int main(int argc, char **argv) {
  double percent, p_byte;
  FILE *f;
  long size, pos;
  unsigned long long flipped = 0;

  if (argc < 4 || strcmp(argv[1], "spray") != 0) {
    fprintf(stderr, "usage: %s spray <percent> <file>\n", argv[0]);
    return 1;
  }
  percent = atof(argv[2]);
  if (percent < 0 || percent > 100) {
    fprintf(stderr, "percent must be in [0, 100]\n");
    return 1;
  }

  f = fopen(argv[3], "r+b");
  if (!f) {
    perror("fopen");
    return 1;
  }
  if (fseek(f, 0, SEEK_END) != 0 || (size = ftell(f)) < 0) {
    perror("fseek");
    return 1;
  }

  srand((unsigned)time(NULL) ^ (unsigned)size);
  /* P(byte untouched) = (1 - p_bit)^8; sample per byte, then pick a
   * uniform bit — a close, cheap approximation for small p. */
  p_byte = 1.0 - percent / 100.0;
  p_byte = 1.0 - p_byte * p_byte * p_byte * p_byte *
                 p_byte * p_byte * p_byte * p_byte;

  for (pos = 0; pos < size; pos++) {
    if ((double)rand() / RAND_MAX < p_byte) {
      int c;
      if (fseek(f, pos, SEEK_SET) != 0) { perror("fseek"); return 1; }
      c = fgetc(f);
      if (c == EOF) break;
      c ^= 1 << (rand() % 8);
      if (fseek(f, pos, SEEK_SET) != 0) { perror("fseek"); return 1; }
      if (fputc(c, f) == EOF) { perror("fputc"); return 1; }
      flipped += 1;
    }
  }
  fclose(f);
  printf("flipped %llu bits in %s\n", flipped, argv[3]);
  return 0;
}
