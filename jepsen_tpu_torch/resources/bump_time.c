/* bump_time: step CLOCK_REALTIME by a signed millisecond offset.
 *
 * Usage: bump_time <delta-ms>
 *
 * Prints the post-adjustment wall-clock time as "<sec>.<nsec>" so the
 * control plane can compute the node's clock offset. Compiled on DB
 * nodes by the clock nemesis (capability reference:
 * jepsen/resources/bump-time.c, driven by nemesis/time.clj:92-96).
 */
#define _POSIX_C_SOURCE 200809L
#include <stdio.h>
#include <stdlib.h>
#include <time.h>

#define NS_PER_SEC 1000000000LL

static void normalize(struct timespec *t) {
  while (t->tv_nsec < 0) {
    t->tv_sec -= 1;
    t->tv_nsec += NS_PER_SEC;
  }
  while (t->tv_nsec >= NS_PER_SEC) {
    t->tv_sec += 1;
    t->tv_nsec -= NS_PER_SEC;
  }
}

int main(int argc, char **argv) {
  struct timespec t;
  long long delta_ns;

  if (argc < 2) {
    fprintf(stderr, "usage: %s <delta-ms>\n", argv[0]);
    return 1;
  }
  delta_ns = (long long)(atof(argv[1]) * 1e6);

  if (clock_gettime(CLOCK_REALTIME, &t) != 0) {
    perror("clock_gettime");
    return 1;
  }
  t.tv_sec += delta_ns / NS_PER_SEC;
  t.tv_nsec += delta_ns % NS_PER_SEC;
  normalize(&t);
  if (clock_settime(CLOCK_REALTIME, &t) != 0) {
    perror("clock_settime");
    return 2;
  }
  if (clock_gettime(CLOCK_REALTIME, &t) != 0) {
    perror("clock_gettime");
    return 1;
  }
  printf("%lld.%09ld\n", (long long)t.tv_sec, t.tv_nsec);
  return 0;
}
