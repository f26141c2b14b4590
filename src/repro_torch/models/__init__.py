"""Model code the serving data plane runs."""
