"""Framework pieces the decode and serving slice needs."""
