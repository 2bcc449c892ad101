"""Learning-rate schedulers (counterpart of
``mlvae_tpu/training/schedulers.py``; YAML alias of
``speechbrain.nnet.schedulers.NewBobScheduler``, which the CTC recipes
build).

NewBob anneals the value by ``annealing_factor`` whenever the relative
improvement of the tracked metric falls below ``improvement_threshold``,
after ``patient`` grace evaluations. As in the JAX package, the recipes
build it and keep it among their checkpoint's recoverables, and nothing
calls it: they train at their constant ``lr``.
"""
from __future__ import annotations


class NewBobScheduler:
    def __init__(self, initial_value: float,
                 improvement_threshold: float = 0.0025,
                 annealing_factor: float = 0.5, patient: int = 0):
        self.hyperparam_value = float(initial_value)
        self.improvement_threshold = improvement_threshold
        self.annealing_factor = annealing_factor
        self.patient = patient
        self.metric_values = []
        self.current_patient = patient

    def __call__(self, metric_value: float):
        """Record ``metric_value``; returns (old value, new value)."""
        old_value = new_value = self.hyperparam_value
        if self.metric_values:
            prev = self.metric_values[-1]
            improvement = 0.0 if prev == 0 else (prev - metric_value) / prev
            if improvement < self.improvement_threshold:
                if self.current_patient == 0:
                    new_value = old_value * self.annealing_factor
                    self.current_patient = self.patient
                else:
                    self.current_patient -= 1
        self.metric_values.append(metric_value)
        self.hyperparam_value = new_value
        return old_value, new_value

    def state_dict(self):
        return {"hyperparam_value": self.hyperparam_value,
                "metric_values": list(self.metric_values),
                "current_patient": self.current_patient}

    def load_state_dict(self, state):
        self.hyperparam_value = state["hyperparam_value"]
        self.metric_values = list(state["metric_values"])
        self.current_patient = state["current_patient"]
