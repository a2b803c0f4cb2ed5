"""NID objective, BFGS and pose refinement."""
