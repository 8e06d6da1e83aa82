/* Exponential curve fitting through the pure-C API.
 *
 * reference: examples/curve_fitting.c (the C-API twin of
 * examples/curve_fitting.cc). This version generates its own noisy samples
 * of y = exp(0.3 x + 0.1) with a deterministic LCG and recovers (m, c) by
 * nonlinear least squares, providing the analytic Jacobian through the C
 * callback — exercising ceres_init / ceres_create_problem /
 * ceres_problem_add_residual_block / ceres_solve end to end.
 *
 * Build: `make curve_fitting_c` in native/ (links libceres_tpu_c_api.so,
 * which embeds Python and drives the solver).
 */

#include <math.h>
#include <stdio.h>

/* --- the C API surface (mirrors include/ceres/c_api.h) --- */
typedef struct ceres_problem_s ceres_problem_t;
typedef int ceres_residual_block_id_t;
typedef int (*ceres_cost_function_t)(void* user_data, double** parameters,
                                     double* residuals, double** jacobians);
typedef void (*ceres_loss_function_t)(void* user_data, double squared_norm,
                                      double out[3]);
extern void ceres_init(void);
extern ceres_problem_t* ceres_create_problem(void);
extern void ceres_free_problem(ceres_problem_t* problem);
extern ceres_residual_block_id_t* ceres_problem_add_residual_block(
    ceres_problem_t* problem, ceres_cost_function_t cost_function,
    void* cost_function_data, ceres_loss_function_t loss_function,
    void* loss_function_data, int num_residuals, int num_parameter_blocks,
    int* parameter_block_sizes, double** parameters);
extern void ceres_solve(ceres_problem_t* problem);

#define NUM_OBSERVATIONS 67

static double data[2 * NUM_OBSERVATIONS]; /* x, y pairs */

static void make_data(void) {
  unsigned long long s = 12345;
  for (int i = 0; i < NUM_OBSERVATIONS; i++) {
    double x = 0.075 * i;
    s = s * 6364136223846793005ULL + 1442695040888963407ULL;
    double noise = ((double)(s >> 11) / 9007199254740992.0 - 0.5) * 0.2;
    data[2 * i] = x;
    data[2 * i + 1] = exp(0.3 * x + 0.1) + noise;
  }
}

/* residual r = y - exp(m x + c); jacobians dr/dm, dr/dc */
static int exponential_residual(void* user_data, double** parameters,
                                double* residuals, double** jacobians) {
  double* measurement = (double*)user_data;
  double x = measurement[0];
  double y = measurement[1];
  double m = parameters[0][0];
  double c = parameters[1][0];
  double e = exp(m * x + c);
  residuals[0] = y - e;
  if (jacobians == NULL) return 1;
  if (jacobians[0] != NULL) jacobians[0][0] = -x * e; /* dr/dm */
  if (jacobians[1] != NULL) jacobians[1][0] = -e;     /* dr/dc */
  return 1;
}

int main(void) {
  double m = 0.0;
  double c = 0.0;
  double* parameter_pointers[] = {&m, &c};
  int parameter_sizes[] = {1, 1};

  make_data();
  ceres_init();
  ceres_problem_t* problem = ceres_create_problem();
  for (int i = 0; i < NUM_OBSERVATIONS; i++) {
    ceres_problem_add_residual_block(
        problem, exponential_residual, &data[2 * i], NULL, NULL, 1, 2,
        parameter_sizes, parameter_pointers);
  }
  ceres_solve(problem);
  ceres_free_problem(problem);
  printf("Final m: %g c: %g (expected ~0.3, ~0.1)\n", m, c);
  return (fabs(m - 0.3) < 0.05 && fabs(c - 0.1) < 0.05) ? 0 : 1;
}
