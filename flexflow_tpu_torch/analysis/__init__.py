"""Static checks over PCGs and substitution rules: the structure pass
behind `Graph.check_correctness` and the substitution-rule lint the
loader runs on every rule (the PyTorch counterparts of the JAX
package's analysis/structure.py and analysis/substitution_lint.py)."""
