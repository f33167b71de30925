"""Clients of the cluster's data plane (the port's copy of the JAX
package's client/, so far its HTTP keep-alive pool)."""
