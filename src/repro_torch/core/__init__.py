"""Core SVM pipeline: tree, kernel blocks, HSS compression, factorization, ADMM."""
