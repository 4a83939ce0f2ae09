from .api import (BatchOptimizer, armijo_line_search, hessian_vector_product,
                  quadratic_exact_step, tree_axpy, tree_dot, tree_scale,
                  tree_zeros_like)
from .gd import GradientDescent
from .newton_cg import NewtonCG

# the reference's other optimizers (cg, lbfgs, adagrad, adamw) come with
# later slices; repro_torch.api.registry names them as not yet ported
REGISTRY = {
    "gd": GradientDescent,
    "newton_cg": NewtonCG,
}
