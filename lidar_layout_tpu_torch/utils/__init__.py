"""Device resolution, weight conversion, host memory and the HTML viewer."""
