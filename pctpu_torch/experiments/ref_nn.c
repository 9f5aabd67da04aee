/* The 1-NN loop of the plain-loop oracle (tests/ref_impl.py: _nn_1_ref),
 * transcribed to C for speed: the same terms in the same order and the
 * same libm call.  numpy's float32 scalar `x ** 2` is libm's powf(x, 2),
 * which is not x*x in the last bit for some x, so the square is powf here
 * too, with the exponent passed in at run time so that the compiler cannot
 * fold it into a product (built with -fno-builtin -ffp-contract=off).
 *
 *   q        (3,)      f32 query
 *   target   (n, 3)    f32
 *   ok       (n,)      u8, nonzero where the target may be picked
 *   two      2.0f
 *   out_d    the winning d² (+inf when no target wins)
 * Returns the winning index: the first strict minimum, 0 when none wins.
 */
#include <math.h>
#include <stdint.h>

int64_t pctpu_ref_nn_1(const float* q, const float* target, const uint8_t* ok, int64_t n,
                       float two, double* out_d) {
  int64_t best_i = 0;
  double best_d = INFINITY;
  for (int64_t j = 0; j < n; ++j) {
    if (!ok[j]) continue;
    float dx = q[0] - target[3 * j];
    float dy = q[1] - target[3 * j + 1];
    float dz = q[2] - target[3 * j + 2];
    float s = powf(dx, two) + powf(dy, two);
    s = s + powf(dz, two);
    double d = (double)s;
    if (d < best_d) {
      best_d = d;
      best_i = j;
    }
  }
  *out_d = best_d;
  return best_i;
}
