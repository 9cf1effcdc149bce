"""The e3 baselines (paper §V-C3) in the port: the Kubernetes VPA (host
only) and the per-service DQN (its Q-networks on the agent's device)."""
from .vpa import VPAAgent, VPAConfig
from .dqn import DQNAgent, DQNConfig, dqn_params_from_numpy

__all__ = ["VPAAgent", "VPAConfig", "DQNAgent", "DQNConfig",
           "dqn_params_from_numpy"]
