/* strobe_time: oscillate the wall clock by +delta ms and back, every
 * period ms, for duration seconds, then restore it.
 *
 * Usage: strobe_time <delta-ms> <period-ms> <duration-s>
 *
 * Tracks the real offset against CLOCK_MONOTONIC so the restore at the
 * end is exact regardless of how many flips ran. Prints the number of
 * clock adjustments made. Compiled on DB nodes by the clock nemesis
 * (capability reference: jepsen/resources/strobe-time.c, driven by
 * nemesis/time.clj:98-102).
 */
#define _POSIX_C_SOURCE 200809L
#include <stdio.h>
#include <stdlib.h>
#include <time.h>

#define NS_PER_SEC 1000000000LL

/* timespec <-> signed nanoseconds; int64 covers ~292 years */
static long long ts_ns(struct timespec t) {
  return (long long)t.tv_sec * NS_PER_SEC + t.tv_nsec;
}

static struct timespec ns_ts(long long ns) {
  struct timespec t;
  t.tv_sec = ns / NS_PER_SEC;
  t.tv_nsec = ns % NS_PER_SEC;
  if (t.tv_nsec < 0) {
    t.tv_sec -= 1;
    t.tv_nsec += NS_PER_SEC;
  }
  return t;
}

static long long now_ns(clockid_t clock) {
  struct timespec t;
  if (clock_gettime(clock, &t) != 0) {
    perror("clock_gettime");
    exit(1);
  }
  return ts_ns(t);
}

static void set_wall_ns(long long ns) {
  struct timespec t = ns_ts(ns);
  if (clock_settime(CLOCK_REALTIME, &t) != 0) {
    perror("clock_settime");
    exit(2);
  }
}

int main(int argc, char **argv) {
  long long delta_ns, period_ns, duration_ns, base_offset, end;
  long long flips = 0;
  int skewed = 0;
  struct timespec period;

  if (argc < 4) {
    fprintf(stderr,
            "usage: %s <delta-ms> <period-ms> <duration-s>\n"
            "Every period ms, toggles the wall clock between its true\n"
            "value and true+delta ms, for duration seconds.\n",
            argv[0]);
    return 1;
  }
  delta_ns = (long long)(atof(argv[1]) * 1e6);
  period_ns = (long long)(atof(argv[2]) * 1e6);
  duration_ns = (long long)(atof(argv[3]) * 1e9);
  period = ns_ts(period_ns);

  /* wall = monotonic + base_offset, as of program start */
  base_offset = now_ns(CLOCK_REALTIME) - now_ns(CLOCK_MONOTONIC);
  end = now_ns(CLOCK_MONOTONIC) + duration_ns;

  while (now_ns(CLOCK_MONOTONIC) < end) {
    skewed = !skewed;
    set_wall_ns(now_ns(CLOCK_MONOTONIC) + base_offset +
                (skewed ? delta_ns : 0));
    flips += 1;
    if (nanosleep(&period, NULL) != 0) {
      perror("nanosleep");
      exit(3);
    }
  }

  set_wall_ns(now_ns(CLOCK_MONOTONIC) + base_offset);
  printf("%lld\n", flips);
  return 0;
}
