"""PaaS fabric: services and replicas, the upstream balancer, the
supervisor (own copies of the reference's host-only modules)."""
