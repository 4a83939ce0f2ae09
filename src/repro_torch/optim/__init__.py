from .api import (BatchOptimizer, armijo_line_search, hessian_vector_product,
                  quadratic_exact_step, tree_add, tree_axpy, tree_dot,
                  tree_norm, tree_scale, tree_sub, tree_zeros_like)
from .gd import GradientDescent
from .nonlinear_cg import NonlinearCG
from .lbfgs import LBFGS
from .newton_cg import NewtonCG
from .adagrad import Adagrad
from .adam import AdamW

REGISTRY = {
    "gd": GradientDescent,
    "cg": NonlinearCG,
    "lbfgs": LBFGS,
    "newton_cg": NewtonCG,
    "adagrad": Adagrad,
    "adamw": AdamW,
}


def make_optimizer(name: str, **kwargs) -> BatchOptimizer:
    return REGISTRY[name](**kwargs)
